"""Legacy RandomState-based seeding (gym<=0.19 style).

The reference calls ``self.np_random.randint`` / ``.shuffle`` throughout
(craftingworld_ray.py:169-176, 599-628, 220-299), which requires the
RandomState API. The implementation (both the ``direct`` RandomState(seed)
scheme and historical gym's ``legacy_hash`` SHA-512 scheme, selected via
``CW_GYMSHIM_SEEDING`` or per call) lives in
:mod:`gym_craftingworld_tpu.parity.seeding` so the host-side parity mirror
shares it without mounting this shim as ``gym``.
"""

from gym_craftingworld_tpu_torch.parity.seeding import (  # noqa: F401
    _bigint_from_bytes,
    _int_list_from_bigint,
    create_seed,
    hash_seed,
    np_random,
)
