"""Mean host milliseconds of one aggregate_device call, from entry to
its return and before any wait: the cost of enqueueing a wide op."""

from cardbench import readers


def read(r):
    return readers.host_ms(r)
