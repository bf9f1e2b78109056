"""The check's control and planted faults, read on the card at a cell's own size.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 --what sound,control,half,token

For each seed, in one process, each of:

* ``sound``: the program as a run drives it (set-up and its check units,
  no window), judged by the reference;
* ``control``: the reference itself put in the program's place, computed
  one precision below the configuration's (each reference's ``control``:
  float8 e4m3 for bfloat16, int8 worlds for the simulator's int16), judged
  by the reference;
* ``stale``, ``half``, ``token``: the program with a fault planted under
  it (each driver's ``plant``): a step that returns its state unchanged,
  half of the batch left out with the mean taken over the rest, an action
  or an answer altered where it is produced.

Prints one JSON line a reading: the cell, seed, what, each compared number,
its limit and the details.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time

import torch

from benchmark.run import ROOT, cell_spec, load_json

FAULTS = ("stale", "half", "token")


def reading(spec: dict, what: str, seed: int, device) -> dict:
    conf, traffic = spec["conf"], spec["traffic"]
    driver = importlib.import_module(f"benchmark.drivers.{spec['module']}")
    ref = importlib.import_module(f"benchmark.reference.{spec['module']}")
    inp = ref.inputs(conf, traffic, seed, device)
    t0 = time.perf_counter()
    if what == "control":
        record = ref.control(conf, traffic, inp, device)
    else:
        plant = contextlib.nullcontext() if what == "sound" else driver.plant(what)
        with plant:
            cell = driver.Cell(conf, traffic, inp, device)
            record = cell.finish()
        del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    numbers, detail = ref.check(conf, traffic, inp, record, device)
    return {"seed": seed, "what": what, "program_s": t1 - t0, "check_s": time.perf_counter() - t1,
            "numbers": numbers, "limits": spec["limits"],
            "fails": sorted(k for k, v in numbers.items() if v > spec["limits"][k]),
            "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="sound,control")
    args = p.parse_args(argv)
    spec = cell_spec(load_json(ROOT / "BENCHMARK.json"), args.workload)
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.what.split(","):
            r = reading(spec, what, seed, device)
            print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
