"""Generate the random-world benchmark suite (a rebuild of
`kinova_create_random_worlds.m` + `saved_worlds/random/`) through the port.

    python -m armour_tpu_torch.generate_worlds [--n 100] [--seed 0] [--out DIR]

Counterpart of `scripts/generate_worlds.py`, over the port's
``generate_world_suite``: ``--n`` worlds of 10, 20 and 40 obstacles in
turn, one CSV each, from ``numpy.random.default_rng(--seed)``.  The
default ``--out`` is under the temp directory (the committed suite in
`assets/worlds/` is never overwritten unless asked for).  The sampling is
host work; ``--device`` (the card unless ``--device cpu`` is given) is
where the collision screen of each candidate runs.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from armour_tpu_torch.device import resolve_device
from armour_tpu_torch.robots.kinova import kinova_gen3_spec
from armour_tpu_torch.sim.scenarios import generate_world_suite


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "armour_tpu_torch_worlds"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    paths = generate_world_suite(kinova_gen3_spec(), args.out, n_worlds=args.n, seed=args.seed,
                                 device=device)
    print(f"wrote {len(paths)} worlds to {args.out}")
    return paths


if __name__ == "__main__":
    main()
