"""Two processes, one (2, 4) mesh of CPU blocks, over gloo.

The port's counterpart of tests/test_multihost.py and
tests/multihost_worker.py: each of two processes joins one gloo group with
explicit arguments (``runtime.initialize``), contributes four CPU blocks
to a (2, 4) mesh (``make_mesh`` gathers them: rank 0 holds the first row
of blocks, rank 1 the second), assembles the DEM from its own blocks
(``host_local_to_global``) and runs TPI at 7 px, valley/ridge at 7 px and
Sx at 300 m, whose halos and global sums cross the process boundary. Each
process checks its own blocks against the port's single pass: TPI at
rtol 1e-5 and atol 2e-2, the valley norm at rtol 1e-4 and atol 2e-3 (the
sums run in another order), Sx bit for bit.

The worker is this file run as a script: ``python test_torch_multihost.py
RANK PORT``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_mesh_over_gloo():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, __file__, str(rank), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"rank {rank} OK" in out


def _worker(rank: int, port: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from topo_descriptors_tpu_torch import ops
    from topo_descriptors_tpu_torch.host import sx_offsets
    from topo_descriptors_tpu_torch.parallel import ShardedOps, make_mesh, runtime

    torch.set_num_threads(1)
    assert runtime.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
    assert runtime.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)  # idempotent
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    mesh = make_mesh((2, 4), ["cpu"] * 4)
    assert mesh.multi_process and len(mesh.local_blocks()) == 4
    assert {mesh.owner(b) for b in mesh.local_blocks()} == {rank}
    sops = ShardedOps(mesh)

    rng = np.random.default_rng(42)  # the same DEM everywhere; only own blocks are used
    dem = (1200 + 300 * rng.standard_normal((64, 96))).astype(np.float32)
    bh, bw = 32, 24
    blocks = [dem[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw] for i, j in mesh.local_blocks()]
    garr = runtime.host_local_to_global(mesh, blocks)

    def own(arr, single, **tol):
        for (i, j), block in arr.blocks.items():
            want = single[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
            if tol:
                np.testing.assert_allclose(block.numpy(), want, **tol)
            else:
                np.testing.assert_array_equal(block.numpy().view(np.int32), want.view(np.int32))

    own(sops.tpi(garr, 7), ops.tpi(dem, 7, device="cpu").numpy(), rtol=1e-5, atol=2e-2)
    norm, _ = sops.valley_ridge(garr, 7, "valley", (0, 0.2))
    own(norm, ops.valley_ridge(dem, 7, "valley", [0, 0.2], device="cpu")[0].numpy(),
        rtol=1e-4, atol=2e-3)
    o, d, b = sx_offsets(30.0, 300.0, 30.0, 30.0)
    own(sops.sx(garr, o, d, b), ops.sx(dem, o, d, b, device="cpu").numpy())
    dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]))
