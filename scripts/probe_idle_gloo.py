"""How much host CPU an idle rank takes on the card: two spawned ranks on
cuda:0 do a matmul (and, where they have one, an all-reduce on their gloo
group), then wait 20 s on an event; each variant prints every rank's CPU
seconds over the wait. Variants: no group; a live group (CUDA tensors);
the group destroyed before the wait; a live group used with CPU tensors.

    python scripts/probe_idle_gloo.py
"""

import multiprocessing
import os
import shutil
import tempfile
import time

WAIT_S = 20
VARIANTS = ("no_group", "live_group", "destroyed_group", "live_group_cpu")


def _rank(rank, init_file, go, results, variant):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    if variant != "no_group":
        dist.init_process_group("gloo", init_method="file://" + init_file,
                                world_size=2, rank=rank)
        x = torch.ones(1000, device="cpu" if variant == "live_group_cpu"
                       else "cuda")
        dist.all_reduce(x)
    a = torch.randn(2048, 2048, device="cuda")
    (a @ a).sum().item()
    if variant == "destroyed_group":
        dist.destroy_process_group()
    t0, cpu0 = time.time(), time.process_time()
    go.wait()
    results.put((variant, rank, round(time.time() - t0, 2),
                 round(time.process_time() - cpu0, 3)))
    if dist.is_initialized():
        dist.destroy_process_group()


def main():
    ctx = multiprocessing.get_context("spawn")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    work = tempfile.mkdtemp(prefix="_smoke_idle_", dir=root)
    try:
        for variant in VARIANTS:
            go, results = ctx.Event(), ctx.Queue()
            procs = [ctx.Process(target=_rank, args=(
                r, os.path.join(work, variant), go, results, variant),
                daemon=True) for r in range(2)]
            for p in procs:
                p.start()
            time.sleep(WAIT_S + 15)        # start-up, then the wait
            go.set()
            for _ in procs:
                v, r, wall, cpu = results.get(timeout=120)
                print("%-16s rank %d: %.3f CPU s over %.2f s waiting"
                      % (v, r, cpu, wall), flush=True)
            for p in procs:
                p.join(60)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
