"""The readings that the cells' limits are set from, on the card: for each
seed, one cell's set-up and a short window of the program, then the check's
numbers of the program against the float32 reference, and of the control
(the reference computed in float8, the precision below the configuration's
bfloat16) against the same reference, on the same requests or steps; for
training on ``--fault-seeds`` also the faults planted in the reference put
in the program's place (half of each batch; the loss x1.5).

    python benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--out <file>]

One JSON line a seed on standard output (and appended to ``--out``).  The
benchmark's own runs never run this."""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out")
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="training: also read the faults planted in the reference on these seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness.main import load_cell, make_runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        runner = make_runner(cell, seed, "cuda:0")
        runner.setup()
        recs = runner.window(0.0, count=cell.traffic.get("sample_requests", 1))
        runner.free()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        line = {"cell": cell.name, "seed": seed, "program": runner.readings(recs),
                "control": runner.readings(recs, quant="fp8")}
        if runner.kind == "train" and seed in args.fault_seeds:
            for fault in ("half_batch", "scaled_loss"):
                line[fault] = runner.readings(recs, fault=fault)
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del runner, recs
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
