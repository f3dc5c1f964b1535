"""The readings that the limits of ``correct`` are set from: for each
seed, the numbers a run of the cell compares and the same numbers read
off the control (the reference computed in bfloat16 in the program's
place), all seeds in one process at the cell's own size and load:

    python3 cardbench/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 1]

Prints one JSON line per seed.  The benchmark's own runs never run the
control."""
import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv) -> int:
    from cardbench import harness

    parser = argparse.ArgumentParser(prog='cardbench/calibrate.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=1.0)
    args = parser.parse_args(argv)
    cell = harness.Cell(harness.load_json(harness.ROOT / 'BENCHMARK.json'),
                        args.workload)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print('calibration runs on a CUDA device', file=sys.stderr)
        return 2
    generator = harness.load_module(
        harness.HERE / 'generators' / f'{cell.traffic["generator"]}.py',
        'cardbench_generator')
    for seed in (int(s) for s in args.seeds.split(',')):
        run = harness.Run(cell, seed, args.seconds, False, time.time())
        generator.run(run, control=True)
        print(json.dumps({
            'seed': seed,
            'readings': {k: c['value'] for k, c in run.checks.items()},
            'control': run.control,
            'units': run.units,
        }), flush=True)
    return 0


if __name__ == '__main__':
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
