"""Parent against change on one CUDA card, in turns (parent, change, change,
parent), each tree in its own process: the median wall of the headline,
halofit and HMcode pipelines (B = 40 000, 16 384 and 4096; median of 9
after two warm-ups).

    python3 -m cosmoprimo_tpu_torch.ab_walls PARENT_ROOT [CHANGE_ROOT]

PARENT_ROOT and CHANGE_ROOT (default: the current directory) each hold a
``cosmoprimo_tpu_torch`` package, e.g. the parent commit unpacked with
``git archive`` into a gitignored folder. Prints one line of walls (ms) per
run, then the card's name and power limit.
"""

import json
import subprocess
import sys

CODE = r'''
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from cosmoprimo_tpu_torch import make_pk_to_xi_pipeline_batched
rng = np.random.default_rng(0)
out = {}
for label, nl, n, nk in (('headline', False, 40000, 1024), ('halofit', 'halofit', 16384, 1024), ('mead', 'mead', 4096, 384)):
    params = [torch.from_numpy(p).to('cuda') for p in (rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n),
              rng.uniform(0.65, 0.70, n), rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))]
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=nk, z=[0.0], non_linear=nl)
    fn(*params); fn(*params)
    walls = []
    for _ in range(9):
        torch.cuda.synchronize(); t0 = time.perf_counter(); fn(*params); torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out[label] = float(np.median(walls))
print(json.dumps(out))
'''


def main(argv):
    trees = {'parent': argv[0], 'change': argv[1] if len(argv) > 1 else '.'}
    for name in ('parent', 'change', 'change', 'parent'):
        res = subprocess.run([sys.executable, '-c', CODE, trees[name]], capture_output=True, text=True, check=True)
        print(name, json.loads(res.stdout.strip().splitlines()[-1]), flush=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    print('card:', card)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
