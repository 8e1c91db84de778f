#!/usr/bin/env python3
"""chip_smoke.py's runtime transfers at other sizes: a tensor's trip
through the port's runtime on one card.

    python3 arg_transfer_probe.py [--mib 256 1024] [--reps 2]

For each size, a bf16 tensor on the card and a float32 tensor on the host
each go through ``chip_smoke._runtime_transfers`` ``--reps`` times (the
first into a cold arena): ``put``, ``get``, a by-value argument into a GPU
``RuntimeEcho`` actor (checked to have been sealed into the arena) and a
round trip through it (bytes checked equal). Prints one JSON line per size
and device with seconds and GB/s, and the card's name and power limit;
exits non-zero without a CUDA device.
"""
import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, nargs="+", default=[256])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("arg_transfer_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    import ray_tpu_torch as rt

    card = chip_smoke.card_line()
    rt.init(object_store_memory=(3 * max(args.mib) << 20) + (2 << 30))
    try:
        actor = rt.remote(num_gpus=1)(chip_smoke.RuntimeEcho).remote()
        rt.get([actor.describe.remote(torch.zeros(1, device=d)) for d in ("cuda", "cpu")],
               timeout=300)
        g = torch.Generator(device="cuda").manual_seed(0)
        for mib in args.mib:
            n = (mib << 20) // 4096
            for x, want in ((torch.randn(n // 2, 4096, generator=g, device="cuda")
                             .to(torch.bfloat16), "cuda:0"),
                            (torch.randn(n // 4, 4096, generator=g, device="cuda").cpu(), "cpu")):
                got = chip_smoke._runtime_transfers(rt, actor, x, want, reps=args.reps)
                print(json.dumps({"mib": mib, **got, "card": card}), flush=True)
    finally:
        rt.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
