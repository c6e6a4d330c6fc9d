"""The readings that the limits of ``correct`` are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds <s1> <s2> ... [--control-seeds ...]

For one cell, in one process (the set-up once): for each seed, the pool of
that seed, as many calls of the closed loop as the check keeps, and the
comparison of the sampled answers with the plain reference, as a run makes
it (the lower readings). For each control seed, the reference itself in
float32 (the precision below the configuration's float64) in the program's
place, on the sampled parameters of that seed, compared in the same way
(the upper readings). One JSON line a seed, then the largest lower and the
smallest upper reading of each output.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import compare, guard, harness, traffic  # noqa: E402


def main(argv, card=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--control-seeds', type=int, nargs='*', default=None)
    args = parser.parse_args(argv)
    cell = harness.Cell(args.workload)
    card = card or harness.Card()
    config, spec = cell.config, cell.traffic
    batch = int(spec['batch'])
    entry = cell.module('entries', cell.config_name).build(config, card.device)
    reference = cell.module('reference', cell.config_name)
    lower, upper = {}, {}
    control_seeds = args.seeds[:3] if args.control_seeds is None else args.control_seeds
    for seed in args.seeds:
        pool = traffic.draw_pool(config['params'], batch, int(spec['pool']), seed)
        pool_dev = [harness.to_device(b, card.device) for b in pool]
        plan = traffic.SamplePlan(seed, spec['check_calls'], spec['check_rows'], batch)
        harness.closed_loop(entry, pool_dev, plan, card, calls=int(spec['check_calls']))
        params, got = harness.sampled(pool, plan, config['params'])
        del pool_dev, plan
        t0 = time.perf_counter()
        ref = reference.compute(params, config)
        ref_s = time.perf_counter() - t0
        line = {'seed': seed, 'rows': len(params[next(iter(params))]), 'reference_s': ref_s,
                'program': {name: value for name, (value, _) in compare.compare(got, ref, config['outputs']).items()}}
        if seed in control_seeds:
            control = reference.compute(params, config, dtype=np.float32)
            line['control'] = {name: value for name, (value, _) in
                               compare.compare(control, ref, config['outputs']).items()}
        for name, value in line['program'].items():
            lower[name] = max(lower.get(name, 0.0), value)
        for name, value in line.get('control', {}).items():
            upper[name] = min(upper.get(name, np.inf), value)
        print(json.dumps(line), flush=True)
    guard.check('after the readings')
    print(json.dumps({'workload': args.workload, 'seeds': len(args.seeds), 'control_seeds': len(control_seeds),
                      'lower': lower, 'upper': upper,
                      'limits': {name: s['limit'] for name, s in config['outputs'].items()},
                      'device': card.describe()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
