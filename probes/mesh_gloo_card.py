"""Can four ranks share the one card over gloo? For each collective the
2×2 mesh's steps issue (all-reduce, all-gather, reduce-scatter,
all-to-all, point-to-point), four processes on card 0 join a gloo
process group and run it once on CUDA tensors, each collective in its
own four processes, so one that kills a rank hides no other; then, if
every one held, the reduced granite-3-2b train and serve steps on a 2×2
(data, model) ``DeviceMesh`` of CUDA tensors against the port without a
mesh. Prints one line a test: held, raised (with the error) or died.

    python3 probes/mesh_gloo_card.py
"""

import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "send_recv",
               "steps")


def rank_main(rank: int, port: int, what: str) -> None:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    try:
        x = torch.full((8, 4), float(rank + 1), device=dev)
        if what == "all_reduce":
            dist.all_reduce(x)
            ok = float(x[0, 0]) == 10.0
        elif what == "all_gather_into_tensor":
            out = torch.empty((32, 4), device=dev)
            dist.all_gather_into_tensor(out, x)
            ok = float(out[8, 0]) == 2.0
        elif what == "reduce_scatter_tensor":
            out = torch.empty((2, 4), device=dev)
            dist.reduce_scatter_tensor(out, x)
            ok = float(out[0, 0]) == 10.0
        elif what == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            ok = float(out[2, 0]) == 2.0
        elif what == "send_recv":
            out = torch.empty_like(x)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % 4),
                dist.P2POp(dist.irecv, out, (rank - 1) % 4)])
            for r in reqs:
                r.wait()
            ok = float(out[0, 0]) == float((rank - 1) % 4 + 1)
        else:
            ok = steps(rank, dev)
        print(f"{what} rank {rank}: {'held' if ok else 'WRONG'}", flush=True)
    except Exception as e:                  # the finding is the error
        print(f"{what} rank {rank}: raised {type(e).__name__}: "
              f"{str(e)[:300]}", flush=True)
        if what == "steps":
            traceback.print_exc()
    finally:
        dist.destroy_process_group()


def steps(rank, dev) -> bool:
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import device_mesh, make_debug_mesh
    from repro_torch.launch.train import synthetic_batch
    from repro_torch.models.model import init_params
    from repro_torch.parallel import sharding as sh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = device_mesh(make_debug_mesh(2, 2), "cuda")
    plan = sh.make_plan(mesh)
    cfg = get_reduced("granite-3-2b")

    def fresh():
        return init_params(cfg, torch.Generator(dev).manual_seed(0),
                           device=dev)
    batch = synthetic_batch(cfg, 0, 4, 32, device=dev)
    want, _, _, _ = cs._mesh_train(torch, cfg, fresh(), batch, None)
    p = fresh()
    got, ms, _, _ = cs._mesh_train(
        torch, cfg, sh.shard_tree(plan, p, sh.param_shardings(plan, p)),
        batch, mesh, steps=2)
    ill = cs._ill_elements(torch, cfg, fresh(), batch)
    leaf = cs._hold_step(torch, got, want, "gloo 2x2 train", ill)
    tokens = cs._serve_tokens(torch, dev, cfg)[:, :35]
    w, _ = cs._mesh_serve(torch, cfg, fresh(), tokens, 4, None)
    p = fresh()
    g, _ = cs._mesh_serve(torch, cfg, sh.shard_tree(
        plan, p, sh.param_shardings(plan, p)), tokens, 4, mesh)
    err = max(cs._rel_err(a, b, "gloo 2x2 serve", cs.MESH_REL)
              for a, b in zip(g, w))
    print(f"steps rank {rank}: train leaves {leaf:.3g}, warm step "
          f"{ms:.1f} ms; serve logits {err:.3g}", flush=True)
    return True


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("mesh_gloo_card: no CUDA device", file=sys.stderr)
        return 2
    for what in COLLECTIVES:
        try:
            mp.start_processes(rank_main, args=(cs._free_port(), what),
                               nprocs=4, start_method="spawn")
        except mp.ProcessExitedException as e:
            print(f"{what}: a rank died: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
