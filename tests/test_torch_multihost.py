"""The port's multi-process scale-out (fastsmc_tpu_torch.parallel.multihost)
on the CPU: the job tiling equal to the JAX package's, the record merge,
four in-process "hosts" and two real processes over gloo on localhost,
each decoding its tiles on a local mesh of two CPU shards. The merged
output covers exactly the pair set of one meshless run (tests/
test_multihost.py and tests/test_sharding.py hold the JAX package so).

Run as a script, this file is the worker of the two-process test:

    python tests/test_torch_multihost.py RANK WORLD PORT ROOT DQ OUT
"""

import gzip
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(argv):
    """Join the gloo group, run this rank's tiles on a 2-shard CPU mesh and
    print the paths and the world size as JSON."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from fastsmc_tpu_torch import DecodingParams
    from fastsmc_tpu_torch.parallel import make_mesh, multihost
    rank, world, port = map(int, argv[:3])
    root, dq, out = argv[3:6]
    torch.set_num_threads(1)
    got = multihost.initialize(f"localhost:{port}", world, rank)
    assert got == rank
    params = DecodingParams.fastsmc_defaults(
        root, dq, os.path.join(out, "mh"), use_known_seed=True, min_m=0.5,
        batch_size=16)
    paths = multihost.run_fastsmc_multihost(
        params, mesh=make_mesh(devices=["cpu"] * 2))
    print(json.dumps({"rank": dist.get_rank(), "paths": paths,
                      "world": dist.get_world_size()}), flush=True)
    dist.barrier()          # neither leaves while the other uses the store
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1:])
    sys.exit(0)

import pytest  # noqa: E402

from fastsmc_tpu.parallel import multihost as jax_multihost  # noqa: E402

import fastsmc_tpu_torch  # noqa: E402
from fastsmc_tpu_torch.parallel import multihost  # noqa: E402


def _pair_cols(path, n):
    with gzip.open(path, "rt") as f:
        return set(tuple(line.split("\t")[:n])
                   for line in f.read().splitlines())


def _single(root, dq, out):
    """One meshless run of the whole panel (jobs=1)."""
    return fastsmc_tpu_torch.FastSMC(
        fastsmc_tpu_torch.DecodingParams.fastsmc_defaults(
            root, dq, out, use_known_seed=True, min_m=0.5, batch_size=16),
        device="cpu").run(verbose=False)


@pytest.mark.parametrize("procs,tpp", [(1, 1), (2, 1), (3, 1), (4, 1),
                                       (2, 2), (3, 3), (8, 2)])
def test_job_tiles_equal_the_jax_package(procs, tpp):
    """Every process's tiles and the tile count as the JAX package's;
    together the tiles are 1..jobs once each."""
    tiles = []
    for p in range(procs):
        got = multihost.job_tiles_for_process(p, procs, tpp)
        assert got == jax_multihost.job_tiles_for_process(p, procs, tpp)
        tiles += got[0]
    assert sorted(tiles) == list(range(1, got[1] + 1))
    assert got[1] >= procs * tpp


def test_merge_ibd_outputs_concatenates_gzip(tmp_path):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"part{i}.ibd.gz")
        with gzip.open(p, "wt") as f:
            f.write(f"line{i}\n")
        paths.append(p)
    out = multihost.merge_ibd_outputs(paths, str(tmp_path / "merged.ibd.gz"))
    with gzip.open(out, "rt") as f:
        assert f.read().splitlines() == ["line0", "line1", "line2"]


def test_initialize_alone_and_with_missing_arguments():
    assert multihost.initialize() == 0
    assert multihost.initialize(num_processes=1) == 0
    with pytest.raises(ValueError, match="process group"):
        multihost.initialize(num_processes=2)


def test_four_hosts_in_process_cover_a_single_job(synthetic_panel_root):
    """Four 'hosts' in one process, each on its tile of jobs=4: the merged
    records have the single run's pairs and segments (first 7 columns)."""
    root, dq, d = synthetic_panel_root
    want = _pair_cols(_single(root, dq, str(d / "mh_single")), 7)
    paths = []
    for pid in range(4):
        params = fastsmc_tpu_torch.DecodingParams.fastsmc_defaults(
            root, dq, str(d / "mh4"), use_known_seed=True, min_m=0.5)
        paths += multihost.run_fastsmc_multihost(
            params, process_id=pid, num_processes=4, device="cpu")
    assert len(paths) == 4
    merged = multihost.merge_ibd_outputs(paths, str(d / "mh4.merged.ibd.gz"))
    assert _pair_cols(merged, 7) == want and want


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(synthetic_panel_root, tmp_path):
    """Two processes join one gloo group on localhost (each sees world
    size 2), take tiles 1, 3 and 2, 4 of jobs=4 and decode them on a local
    mesh of two CPU shards; the merged records cover the pair set of one
    meshless run (first 6 columns)."""
    root, dq, _ = synthetic_panel_root
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port), root, dq, str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for rank in range(2)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            results.append(json.loads(out.splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["world"] == 2 for r in results)
    paths = [p for r in results for p in r["paths"]]
    jobs = sorted(p.rsplit(".FastSMC", 1)[0].split(".")[-2] for p in paths)
    assert jobs == ["1", "2", "3", "4"]
    merged = multihost.merge_ibd_outputs(paths,
                                         str(tmp_path / "merged.ibd.gz"))
    want = _pair_cols(_single(root, dq, str(tmp_path / "single")), 6)
    assert _pair_cols(merged, 6) == want and want
