"""Second-process wire server: ``python -m roaringbitmap_tpu_torch.wire.bootstrap``.

Builds the SAME seeded dataset as the parent (both sides call
``serving.replay.build_dataset`` with the same knobs, so parity needs no
data shipping), stands up a :class:`WireServer` over a ``ServingLoop`` (or
a ``PodFrontDoor`` over a simulated N-host pod with ``--frontdoor N``, the
migration-capable target) on ``--device`` (the card by default; ``--device
cpu`` for the CPU), prints ONE JSON line::

    {"port": 12345, "host": "127.0.0.1", "sets": 2, "pid": 4242,
     "device": "cuda:0"}

to stdout, then serves until **stdin closes**: the parent owns the child's
lifetime through the pipe, so a dead parent never leaks a listening
server.  Faults arrive through ``ROARING_TPU_FAULTS`` in the child's
environment.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_auth(pairs) -> dict | None:
    """``token=t0,t1`` / ``token=*`` CLI grants -> WireServer auth."""
    if not pairs:
        return None
    auth = {}
    for p in pairs:
        token, _, grants = p.partition("=")
        auth[token] = [g for g in grants.split(",") if g] or ["*"]
    return auth


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m roaringbitmap_tpu_torch.wire.bootstrap",
        description="deterministic second-process wire server")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--sources", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--density", type=int, default=4096)
    ap.add_argument("--users", type=int, default=1 << 20)
    ap.add_argument("--no-columns", action="store_true",
                    help="skip the analytics column attach")
    ap.add_argument("--device", default="cuda",
                    help="where the resident sets live and the loop "
                         "serves: cuda (default) or cpu")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral (the printed JSON says which)")
    ap.add_argument("--auth", action="append", default=None,
                    metavar="TOKEN=T0,T1",
                    help="repeatable auth grant (TOKEN=* grants all "
                         "tenants); omitted = auth off")
    ap.add_argument("--pool-target", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--deadline-ms", type=float, default=10_000.0)
    ap.add_argument("--frontdoor", type=int, default=0, metavar="HOSTS",
                    help="serve a PodFrontDoor over a simulated N-host "
                         "pod instead of a bare ServingLoop")
    ap.add_argument("--max-inflight", type=int, default=256)
    ap.add_argument("--coalesce-s", type=float, default=0.002)
    args = ap.parse_args(argv)

    from ..parallel.multiset import DeviceBitmapSet, MultiSetBatchEngine
    from ..runtime import guard
    from ..serving import replay
    from ..serving.loop import ServingLoop, ServingPolicy
    from .server import WireServer

    profile = replay.ReplayProfile(
        sets=args.sets, sources=args.sources, tenants=args.tenants,
        density=args.density, users=args.users, seed=args.seed,
        analytics_col="" if args.no_columns else "v")
    bitmap_sets, columns = replay.build_dataset(profile)
    sets = [DeviceBitmapSet(b, layout="dense", device=args.device)
            for b in bitmap_sets]
    replay.attach_columns(sets, profile, columns)
    policy = ServingPolicy(
        pool_target=args.pool_target, max_queue=args.max_queue,
        default_deadline_ms=args.deadline_ms,
        guard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None))
    if args.frontdoor:
        from ..parallel import podmesh
        from ..serving.frontdoor import PodFrontDoor

        loop = PodFrontDoor(
            sets, pod=podmesh.PodMesh.simulate(
                args.frontdoor, devices=[sets[0].device] * args.frontdoor),
            policy=policy)
    else:
        loop = ServingLoop(MultiSetBatchEngine(sets), policy)
    server = WireServer(loop, host=args.host, port=args.port,
                        auth=_parse_auth(args.auth),
                        max_inflight=args.max_inflight,
                        coalesce_s=args.coalesce_s,
                        name=f"bootstrap-{args.seed}")
    server.start()
    host, port = server.address
    print(json.dumps({"port": port, "host": host, "sets": args.sets,
                      "pid": os.getpid(), "device": str(loop.device)}),
          flush=True)
    try:
        sys.stdin.buffer.read()       # parent closes the pipe -> exit
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
