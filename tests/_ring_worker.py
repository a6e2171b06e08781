"""Worker of tests/test_torch_ring.py: one rank of an 8-process gloo
group on a (2, 4) ("data", "model") mesh. It imports no jax: the parent
process computes the references."""
import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, port: int, path: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import layers as L
    from repro_torch.models import zoo
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        job = torch.load(path, weights_only=False)
        ring = L.Ring(mesh, "data", "model")
        bi, nb = ring.coord("data")
        si, ns = ring.coord("model")
        out = {}
        q, k, v = job["qkv"]
        b, s = q.shape[:2]

        def mine(t):
            return t[bi * (b // nb):(bi + 1) * (b // nb),
                     si * (s // ns):(si + 1) * (s // ns)]

        spec = ("batch", "seq", None, None)
        got = L.ring_flash_attention(
            *(ring.shard(mine(t), spec) for t in (q, k, v)), job["attn_cfg"],
            mesh, batch_axis="data", seq_axis="model")
        out["ring"] = got.full_tensor()
        for name, (cfg, state, batch) in job["models"].items():
            model = zoo.build_model(cfg, torch.device("cpu"))
            model.load_state_dict(state)
            step = zoo.make_prefill_step(cfg, ring=(mesh, "data", "model"))
            logits, cache = step(model, batch)
            out[name] = (logits.full_tensor(),
                         {n: c.full_tensor() for n, c in cache.items()})
        if rank == 0:
            torch.save(out, path + ".out")
    finally:
        dist.destroy_process_group()


def spawn(path: str, world: int = 8, timeout: float = 120.0) -> dict:
    """Run ``run`` on ``world`` spawned ranks; rank 0's results."""
    import socket
    import time

    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(run, args=(world, port, path), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ring ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in ctx.processes):
        raise RuntimeError(f"ring ranks exited {[p.exitcode for p in ctx.processes]}")
    return torch.load(path + ".out", weights_only=False)
