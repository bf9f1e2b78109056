"""Episode GIF recorder — host-side counterpart of the reference's
``allow_gif_storage``/``__render_gif`` pipeline (craftingworld_ray.py:565-597,
769-782).

The reference appends matplotlib artists every step and saves an
ArtistAnimation at the next reset as
``renders/env{id}/E{ep}({steps})_{desired-idxs}({achieved-idxs}).gif``.
Here frames are device-rendered uint8 arrays pulled to host; the writer
reproduces the two-panel (state | goal) layout, title/goal text and the object
legend, and the exact file-naming scheme.

Deviation recorded in SURVEY §7: the reference's ``__render_gif`` references
``self.ax`` which only exists after ``allow_gif_storage()`` (a latent crash
path, craftingworld_ray.py:584 vs :781); this implementation has no such
trap.
"""

from __future__ import annotations

import os
from textwrap import wrap

import numpy as np

from gym_craftingworld_tpu_torch import constants as C


class GifRecorder:
    """Collects per-step frames for one episode and writes animated GIFs."""

    def __init__(self, root: str = "renders", env_id: int | None = None,
                 save_rate: int = 1):
        self.env_id = env_id if env_id is not None else int(
            np.random.randint(0, 1_000_000)
        )
        self.dir = os.path.join(root, f"env{self.env_id}")
        os.makedirs(self.dir, exist_ok=True)
        self.save_rate = max(1, int(save_rate))
        self._frames: list = []

    def add_frame(self, state_img, goal_img, ep_no, step_num, action_label,
                  reward, desired, achieved):
        self._frames.append(
            (
                np.asarray(state_img),
                np.asarray(goal_img),
                int(ep_no),
                int(step_num),
                action_label,
                int(reward),
                np.asarray(desired).copy(),
                np.asarray(achieved).copy(),
            )
        )

    def reset_episode(self):
        self._frames = []

    def should_record(self, ep_no: int) -> bool:
        return ep_no % self.save_rate == 0

    def save_episode(self, ep_no: int, step_num: int, desired, achieved) -> str | None:
        """Write the collected frames; returns the path (or None if empty)."""
        if not self._frames:
            return None
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.animation as animation
        import matplotlib.patches as mpatches
        import matplotlib.pyplot as plt

        desired = np.asarray(desired).reshape(-1)
        achieved = np.asarray(achieved).reshape(-1)
        tasknums = "-".join(str(i) for i in np.flatnonzero(desired == 1))
        completed = "-".join(str(i) for i in np.flatnonzero(achieved == 1))
        path = os.path.join(
            self.dir, f"E{ep_no}({step_num})_{tasknums}({completed}).gif"
        )

        fig = plt.figure()
        ax1 = fig.add_subplot(1, 2, 1)
        ax2 = fig.add_subplot(1, 2, 2)
        colors_rgba = [tuple(c / 255.0 for c in col) + (0.9,) for col in
                       np.asarray(C.COLORS)]
        patches = [
            mpatches.Patch(color=colors_rgba[i], label=C.OBJECTS[i])
            for i in range(len(C.OBJECTS))
        ]
        ims = []
        for (img, goal, ep, st, act, rew, des, ach) in self._frames:
            im1 = ax1.imshow(img, animated=True)
            im2 = ax2.imshow(goal)
            des_names = "\n".join(
                wrap(", ".join(C.TASK_LIST[k] for k in np.flatnonzero(des == 1)), 50)
            )
            ach_names = "\n".join(
                wrap(", ".join(C.TASK_LIST[k] for k in np.flatnonzero(ach == 1)), 50)
            )
            ttl = ax1.text(
                0.0, 1.01,
                f"\nEpisode {ep}: step {st} - action choice: {act}\n"
                f"Desired Goals: {des_names}",
                horizontalalignment="left", verticalalignment="bottom",
                transform=ax1.transAxes,
            )
            txt = ax1.text(
                0.0, -0.02,
                f"Achieved Goals: {ach_names}\nd_g: {des}\na_g: {ach},   r: {rew}",
                horizontalalignment="left", verticalalignment="top",
                transform=ax1.transAxes,
            )
            ims.append([im1, im2, ttl, txt])
        ax1.set_xticks([]), ax1.set_yticks([])
        ax2.set_xticks([]), ax2.set_yticks([])
        ax1.legend(handles=patches, bbox_to_anchor=(1.025, 1), loc=2,
                   borderaxespad=0.0)
        anim = animation.ArtistAnimation(
            fig, ims, interval=100000, blit=False, repeat_delay=1000
        )
        anim.save(path, writer=animation.PillowWriter(), dpi=100)
        plt.close(fig)
        self._frames = []
        return path
