"""Why ``profile_stages`` times a stage with the CPU clock on the CPU.

    python3 tests/torch_stage_clock.py [busy_processes] [trials]   (default 14, 10)

Starts ``busy_processes`` spinning Python processes (more runnable threads
than cores, as a parallel test run makes), then times the two stages of the
pipeline test's probe (``tests/test_torch_pipeline_parallel.py``: 6 layers
of d_model 16 split (0, 3), (3, 6), activation [16, 32, 16], one torch
thread) as ``profile_stages`` does, 9 interleaved rounds after one warm-up
and the median of each stage, by the wall clock and by the process's CPU
clock at once, and prints each trial's two pairs of stage fractions. The
busy processes are stopped at the end. CPU only; about a minute.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUSY = "import time\nend = time.time() + {s}\nwhile time.time() < end:\n    pass\n"


def stage_fractions(trials, repeats=9):
    from deeplearning4j_tpu_torch.models import transformer as T
    from deeplearning4j_tpu_torch.parallel.pipeline import _block_stage_fn

    torch.set_num_threads(1)
    cfg = T.TransformerConfig(vocab_size=64, max_len=32, d_model=16, n_heads=2, n_layers=6,
                              d_ff=32, dropout=0.0, compute_dtype=torch.float32)
    model = T.init_params(0, cfg, device="cpu")
    names = [n for n, _ in model.blocks[0].named_parameters()]
    blocks = {n: torch.stack([dict(b.named_parameters())[n].detach() for b in model.blocks])
              for n in names}
    stages = [{k: v[a:b] for k, v in blocks.items()} for a, b in ((0, 3), (3, 6))]
    fn = _block_stage_fn(cfg)
    h = torch.zeros((16, 32, 16))
    for _ in range(trials):
        wall, cpu = [[], []], [[], []]
        with torch.no_grad():
            for r in range(repeats + 1):
                for s, stage in enumerate(stages):
                    w0, c0 = time.perf_counter(), time.process_time()
                    fn(stage, h)
                    if r:
                        wall[s].append(time.perf_counter() - w0)
                        cpu[s].append(time.process_time() - c0)
        for what, t in (("wall", wall), ("cpu", cpu)):
            med = np.array([np.median(x) for x in t])
            print(what, (med / med.sum()).round(3).tolist(), end="  ")
        print(flush=True)


def main(busy=14, trials=10):
    procs = [subprocess.Popen([sys.executable, "-c", BUSY.format(s=600)])
             for _ in range(busy)]
    try:
        time.sleep(1.0)
        stage_fractions(trials)
    finally:
        for p in procs:
            p.kill()
            p.wait()


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
