from gym_craftingworld_tpu_torch.render.raster import (
    render_altobs,
    render_onehot,
    render_ray,
    state_images_altobs,
    state_images_ray,
    state_obs_onehot,
)

__all__ = [
    "render_altobs",
    "render_onehot",
    "render_ray",
    "state_images_altobs",
    "state_images_ray",
    "state_obs_onehot",
]
