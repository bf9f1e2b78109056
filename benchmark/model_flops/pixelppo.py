"""The conv stem: two 3x3 SAME convolutions, a dense layer, two heads."""


def forward(conf: dict) -> float:
    env = conf["env"]
    h, w = env["height"], env["width"]
    macs = 0
    c_in = 12
    for c_out, s in ((conf["conv1"], conf["stride1"]), (conf["conv2"], 2)):
        h, w = -(-h // s), -(-w // s)
        macs += h * w * c_out * 9 * c_in
        c_in = c_out
    macs += (h * w * c_in + 22) * conf["hidden"] + conf["hidden"] * (conf["actions"] + 1)
    return 2.0 * macs
