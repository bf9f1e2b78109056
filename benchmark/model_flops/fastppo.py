"""The MLP actor-critic: F -> H -> H -> (6 logits + 1 value)."""


def forward(conf: dict) -> float:
    F, H, A = conf["features"], conf["hidden"], conf["actions"]
    return 2.0 * (F * H + H * H + (A + 1) * H)


def ppo_grads(n: int, F: int, H: int) -> float:
    """The minibatch gradient kernel's work over ``n`` rows: a forward and
    the two backward products of each layer, 6 n (F H + H H + 7 H)."""
    return 6.0 * n * (F * H + H * H + 7 * H)
