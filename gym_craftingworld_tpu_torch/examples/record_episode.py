"""Demo: roll a random policy for one episode and save it as a GIF.

Counterpart of the JAX package's ``examples/record_episode.py`` (the
reference's ``renders/`` pipeline): a Flat env from ``api.make`` records
every frame through ``utils/gif.py``'s ``GifRecorder`` and writes the episode
under ``renders/env{id}/`` of the working directory at the next reset.
``utils/gif.py`` draws with matplotlib; where matplotlib is not installed the
episode is written with Pillow alone (``PillowGifRecorder``: the state and
goal frames side by side, under the same file name).

    python -m gym_craftingworld_tpu_torch.examples.record_episode            # on the card
    python -m gym_craftingworld_tpu_torch.examples.record_episode --device cpu
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

from gym_craftingworld_tpu_torch.api import make
from gym_craftingworld_tpu_torch.utils.gif import GifRecorder


class PillowGifRecorder(GifRecorder):
    """``GifRecorder`` whose episodes are written with Pillow alone: each frame
    the state and goal images side by side, 4x enlarged."""

    def save_episode(self, ep_no: int, step_num: int, desired, achieved) -> str | None:
        if not self._frames:
            return None
        from PIL import Image

        tasknums = "-".join(str(i) for i in np.flatnonzero(np.asarray(desired).reshape(-1) == 1))
        completed = "-".join(str(i) for i in np.flatnonzero(np.asarray(achieved).reshape(-1) == 1))
        path = os.path.join(self.dir, f"E{ep_no}({step_num})_{tasknums}({completed}).gif")
        frames = []
        for img, goal, *_ in self._frames:
            gap = np.full((img.shape[0], 4, 3), 255, np.uint8)
            both = np.concatenate([img, gap, goal], axis=1).astype(np.uint8)
            frames.append(Image.fromarray(both).resize((4 * both.shape[1], 4 * both.shape[0]),
                                                       Image.NEAREST))
        frames[0].save(path, save_all=True, append_images=frames[1:], duration=100, loop=0)
        self._frames = []
        return path


def matplotlib_installed() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def main(argv=None) -> str:
    """Record one episode; returns the directory it was written to."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    env = make("craftingworldflat-v3", seed=0, max_steps=40, render_save_rate=1,
               device=args.device)
    env.allow_gif_storage()
    if not matplotlib_installed():
        env._recorder = PillowGifRecorder(env_id=env.env_id, save_rate=env.render_save_rate)
    env.reset()
    rng = np.random.RandomState(0)
    done = False
    while not done:
        _, _, done, _ = env.step(int(rng.randint(6)))
    env.reset()  # flushes the recorded episode to renders/env{id}/
    print(f"episode saved under {env._recorder.dir}/ ({type(env._recorder).__name__})")
    return env._recorder.dir


if __name__ == "__main__":
    main()
