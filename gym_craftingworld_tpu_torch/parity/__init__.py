from gym_craftingworld_tpu_torch.parity import oracle
from gym_craftingworld_tpu_torch.parity.host_rng import ParityReset

__all__ = ["ParityReset", "oracle"]
