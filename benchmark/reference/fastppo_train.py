"""Reference of fast-PPO training: the MLP actor-critic over 67 features.

The policy (``fastppo-mlp512-ray21``): ``h1 = relu(w1 x + b1)``, ``h2 =
relu(w2 h1 + b2)``, logits ``wl h2 + bl``, value ``wv h2 + bv``. In the
collect (feature-major, ``[F, B]``) each product takes bf16 operands with
float32 sums, the heads' sums in float64 on the card (float32 on the CPU),
and ``h1`` stays float32 until it is the next product's operand. In the
update (batch-major) the trunk's pre-activations round to bf16 and the
backward rounds the heads' cotangents and ``dh2``, ``dh1`` to bf16, with
float32 weight gradients summed over the rows, as the configuration states.

``inputs`` makes what the benchmark hands both sides from the seed: the
weights (He-normal from a ``torch.Generator`` on the device, zero biases),
the pool kernel's two seed words of the first worlds, and the training
key. ``run`` follows the program's record (or, with ``follow`` None, stands
in the program's place) over ``steps`` iterations.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import keys as K
from benchmark.reference import ppo
from benchmark.reference import world as W
from benchmark.reference.rounding import round_to

f32, bf16 = torch.float32, torch.bfloat16
NAMES = ("w1", "b1", "w2", "b2", "wl", "bl", "wv", "bv")


def inputs(conf: dict, traffic: dict, seed: int, device) -> dict:
    F, H, A = conf["features"], conf["hidden"], conf["actions"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    shapes = {"w1": (H, F), "w2": (H, H), "wl": (A, H), "wv": (1, H)}
    fans = {"w1": F, "w2": H, "wl": H, "wv": H}
    z = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    weights, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        weights[k] = z[at:at + n].reshape(s) * math.sqrt(2.0 / fans[k]) * (0.01 if k == "wl" else 1.0)
        at += n
    for k, n in (("b1", H), ("b2", H), ("bl", A), ("bv", 1)):
        weights[k] = torch.zeros(n, device=device)
    k_env, k_train = K.split(K.key_data(seed, device), 2)
    words = K.randint(k_env, (2,), 0, 2**31 - 1)
    return {"weights": {k: weights[k] for k in NAMES}, "pool_seeds": [int(w) for w in words],
            "key": k_train}


def policy(conf: dict, B: int, dt=bf16) -> ppo.Policy:
    env = conf["env"]
    h_, w_, ms = env["height"], env["width"], env["max_steps"]
    op = lambda x: x.to(dt).to(f32)

    def feats(te):
        return W.features(te, h_, w_, ms)

    def collect(p, te):
        x = feats(te)
        acc = torch.float64 if x.is_cuda else f32
        h = torch.relu(op(p["w1"]) @ op(x) + p["b1"][:, None])
        h = torch.relu(op(p["w2"]) @ op(h) + p["b2"][:, None])
        head = lambda w: (op(w).to(acc) @ op(h).to(acc)).to(f32)
        return head(p["wl"]) + p["bl"][:, None], (head(p["wv"]) + p["bv"][:, None])[0]

    def forward(p, stored, rows):
        x = ppo._rows(stored, rows, B).to(f32)  # [n, F]
        w = lambda k: round_to(p[k], dt)  # straight through: float32 weight gradients
        act = lambda z: round_to(torch.relu(round_to(z, dt)), None, bf16)
        h1 = act(round_to(x, dt) @ w("w1").T + p["b1"])
        h2 = act(round_to(h1, dt) @ w("w2").T + p["b2"])
        heads = round_to(round_to(h2, dt) @ torch.cat([w("wl"), w("wv")]).T, None, bf16)
        heads = heads + torch.cat([p["bl"], p["bv"]])
        return heads[:, :6].T, heads[:, 6]

    return ppo.Policy(collect, feats, forward, shuffle_block(conf, B))


def shuffle_block(conf: dict, B: int) -> int:
    """The largest power-of-two multiple of 128 up to 2,048 rows that tiles
    every minibatch and leaves at least 8 blocks in each."""
    rows = conf["rollout_steps"] * B // conf["num_minibatches"]
    cands = [b for b in (2048, 1024, 512, 256, 128) if rows % b == 0]
    return next((b for b in cands if 8 * b <= rows), cands[-1])


def run(conf: dict, traffic: dict, inp: dict, follow, steps: int, device, dt=bf16):
    """(Record, action gap) of ``steps`` iterations from the inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, env = traffic["envs"], conf["env"]
    place = lambda s0, s1, n: W.pool(s0, s1, n, env["height"], env["width"],
                                     env["number_of_tasks"], device)

    def pool_fn(k_pool, n):
        s0, s1 = (int(x) for x in K.randint(k_pool, (2,), 0, 2**31 - 1))
        return place(s0, s1, n)

    env0 = place(*inp["pool_seeds"], B)
    return ppo.iterate(conf, policy(conf, B, dt), inp["weights"], env0, inp["key"], steps, B,
                       pool_fn, follow)


def check(conf: dict, traffic: dict, inp: dict, record, device) -> dict:
    ref, gap = run(conf, traffic, inp, record, len(record.actions), device)
    return ppo.compare(conf, record, ref, gap)


def control(conf: dict, traffic: dict, inp: dict, device):
    """The reference in the program's place one precision below the
    configuration's bfloat16: float8 e4m3 operands and activations."""
    return run(conf, traffic, inp, None, traffic["check_steps"], device, torch.float8_e4m3fn)[0]
