"""Phase 18's sharded holds of ``chip_smoke.py`` for a tree given on the
command line, printed and not stopped at the first failure: the base
``DynamicFusionConfig()`` over ``make_mesh(4)`` on one card, three steps of
``bench.py``'s deforming scene, each step's LM iterations held against the
single device (``chip_smoke.hold_sharded_solve``) and the median
final-cost ratio over 2, 4 and 8 shards.

    python3 scripts/torch_sharded_base_holds.py --root DIR

``--root`` is the directory holding the ``dynamicfusion_tpu_torch`` to run
(this checkout by default; an unpacked ``git archive`` of another commit,
or a copy with one kernel constant changed, to see how a sum order moves
the holds' margins). The kernels build from that tree's sources.
"""

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=str(HERE), help="directory holding the dynamicfusion_tpu_torch to run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sharded_base_holds: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    from dynamicfusion_tpu_torch import kernels
    from dynamicfusion_tpu_torch.config import DynamicFusionConfig
    from dynamicfusion_tpu_torch.io import synthetic
    from dynamicfusion_tpu_torch.parallel import sharded

    assert Path(kernels.__file__).resolve().is_relative_to(root), kernels.__file__
    results = []

    def check(name, ok, msg):  # print every hold, stop at none
        results.append(ok)
        print(f"[check] {root.name} {name}: {msg} -> {'PASS' if ok else 'FAIL'}", flush=True)

    cs.check = check
    kernels.load()
    dev = torch.device("cuda")
    nr = DynamicFusionConfig.default_dynamicfusion()
    depths = synthetic.deforming_frames(nr.intr, nr.rows, nr.cols, 4)
    mesh = sharded.make_mesh(cs.SHARDS, devices=[dev] * cs.SHARDS)
    cs.drive_sharded(torch, "sharded_base", DynamicFusionConfig(), mesh, dev, depths, hold_from=1)
    print(f"[holds] {cs.smi()} | {root}: {sum(results)} of {len(results)} passed", flush=True)
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
