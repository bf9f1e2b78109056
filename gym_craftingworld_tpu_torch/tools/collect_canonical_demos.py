"""Collect expert demonstrations at the canonical 21x21 stacked setting.

Counterpart of the JAX package's ``tools/collect_canonical_demos.py``, with
its arguments: 24,000 episodes, seed 0, DART noise 0.05, lockstep batches of
192. ``train/demos.collect_expert_demos`` steps the batch through the grid
step on the card (``--device``) and runs the scripted expert on the host; the
JAX tool ran both on the CPU. Writes a ``SnapDataset`` npz, which the JAX
package's ``SnapDataset.load`` reads too.

    python -m gym_craftingworld_tpu_torch.tools.collect_canonical_demos        # on the card
    python -m gym_craftingworld_tpu_torch.tools.collect_canonical_demos --device cpu \\
        --episodes 8 --batch 4 --out /tmp/demos.npz                            # a small CPU run
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from gym_craftingworld_tpu_torch.tools._canonical import CFG, DEMOS
from gym_craftingworld_tpu_torch.train.demos import SnapDataset, collect_expert_demos
from gym_craftingworld_tpu_torch.utils.profiling import card_identity


def main(argv=None) -> SnapDataset:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--episodes", type=int, default=24000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-eps", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=192)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=str(DEMOS))
    args = ap.parse_args(argv)

    tag = f"[{card_identity(args.device)}]"
    t0 = time.time()

    def progress(done_batches, n_batches, kept):
        dt = time.time() - t0
        print(f"{tag} [{dt:7.1f}s] batch {done_batches}/{n_batches}, {kept} episodes kept "
              f"({kept / dt:.1f} eps/s, host clock)", flush=True)

    snaps = collect_expert_demos(CFG, args.episodes, seed=args.seed, noise_eps=args.noise_eps,
                                 batch=args.batch, progress=progress, device=args.device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    snaps.save(str(out))
    dt = time.time() - t0
    print(f"{tag} done: {snaps.num_episodes} episodes, {snaps.num_rows} rows in {dt:.1f} s "
          f"({60 * args.episodes / dt:.1f} episodes a minute, host clock) -> {out}", flush=True)
    return snaps


if __name__ == "__main__":
    main()
