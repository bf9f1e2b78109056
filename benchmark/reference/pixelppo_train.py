"""Reference of pixel-PPO training: the conv stem over the 12-channel grid.

The policy (``pixelppo-conv32-ray21``): two 3x3 convolutions (XLA's SAME
pads, NHWC, kernels HWIO) of 32 and 64 channels, the first with stride 2,
the second stride 2, each in bf16 with its bias added in bf16 and a relu;
the flattened map and the 22 goal and holding bits into a dense layer of
256 (bf16 operands, float32 sums and bias, relu, rounded to bf16); the
heads as bf16 products rounded to bf16 plus float32 biases. Every bf16
value of the program is a float32 value rounded to bf16 here, forward and
backward (the program's autograd rounds its gradients where its tensors are
bf16); the convolutions and products run in float32 with TF32 off.

``inputs``: the weights (He-normal from a ``torch.Generator`` on the device,
zero biases), the key of the first worlds (``fresh_packed_batch``), the
training key.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import keys as K
from benchmark.reference import ppo
from benchmark.reference import world as W
from benchmark.reference.rounding import round_to

f32, bf16 = torch.float32, torch.bfloat16
NAMES = ("k1", "b1", "k2", "b2", "w1", "bd", "wl", "bl", "wv", "bv")


def flat_dim(conf: dict) -> int:
    env, s = conf["env"], conf["stride1"]
    out = lambda n: -(-(-(-n // s)) // 2)
    return out(env["height"]) * out(env["width"]) * conf["conv2"]


def inputs(conf: dict, traffic: dict, seed: int, device) -> dict:
    c1, c2, hid, A = conf["conv1"], conf["conv2"], conf["hidden"], conf["actions"]
    flat = flat_dim(conf)
    shapes = {"k1": (3, 3, 12, c1), "k2": (3, 3, c1, c2), "w1": (flat + 22, hid),
              "wl": (hid, A), "wv": (hid, 1)}
    fans = {"k1": 9 * 12, "k2": 9 * c1, "w1": flat + 22, "wl": hid, "wv": hid}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    z = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    weights, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        weights[k] = z[at:at + n].reshape(s) * math.sqrt(2.0 / fans[k]) * (0.01 if k == "wl" else 1.0)
        at += n
    for k, n in (("b1", c1), ("b2", c2), ("bd", hid), ("bl", A), ("bv", 1)):
        weights[k] = torch.zeros(n, device=device)
    k_env, k_train = K.split(K.key_data(seed, device), 2)
    return {"weights": {k: weights[k] for k in NAMES}, "env_key": k_env, "key": k_train}


def _conv(x: torch.Tensor, k: torch.Tensor, s: int) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with HWIO ``k``, float32."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad lists the last dims first
        total = max((-(-n // s) - 1) * s + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, (0, 0, *pads))
    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)


def forward(p: dict, grid, bits, stride1: int, dt=bf16):
    """(logits f32[n, 6], value f32[n]) of bf16 grids [n, H, W, 12] and bits [n, 22]."""
    q = lambda x: round_to(x, dt, bf16)
    x = torch.relu(q(q(_conv(grid.to(f32), q(p["k1"]), stride1)) + q(p["b1"])))
    x = torch.relu(q(q(_conv(x, q(p["k2"]), 2)) + q(p["b2"])))
    x = torch.cat([x.reshape(x.shape[0], -1), bits.to(f32)], dim=1)
    h = q(torch.relu(x @ q(p["w1"]) + p["bd"]))
    return q(h @ q(p["wl"])) + p["bl"], (q(h @ q(p["wv"])) + p["bv"])[:, 0]


def policy(conf: dict, B: int, dt=bf16) -> ppo.Policy:
    env = conf["env"]
    hh, ww = env["height"], env["width"]

    def collect(p, te):
        logits, value = forward(p, *W.render(te, hh, ww), conf["stride1"], dt)
        return logits.T, value

    def fwd(p, stored, rows):
        logits, value = forward(p, *W.render(ppo._rows(stored, rows, B), hh, ww),
                                conf["stride1"], dt)
        return logits.T, value

    return ppo.Policy(collect, lambda te: te, fwd, conf["shuffle_block"])


def run(conf: dict, traffic: dict, inp: dict, follow, steps: int, device, dt=bf16):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, env = traffic["envs"], conf["env"]
    place = lambda k, n: W.keyed_batch(k, n, env["height"], env["width"], env["number_of_tasks"])
    return ppo.iterate(conf, policy(conf, B, dt), inp["weights"], place(inp["env_key"], B),
                       inp["key"], steps, B, place, follow)


def check(conf: dict, traffic: dict, inp: dict, record, device) -> dict:
    ref, gap = run(conf, traffic, inp, record, len(record.actions), device)
    return ppo.compare(conf, record, ref, gap)


def control(conf: dict, traffic: dict, inp: dict, device):
    """The reference in the program's place one precision below the
    configuration's bfloat16: float8 e4m3 operands and activations."""
    return run(conf, traffic, inp, None, traffic["check_steps"], device, torch.float8_e4m3fn)[0]
