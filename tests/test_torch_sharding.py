"""The port's mesh (fastsmc_tpu_torch.parallel.sharding) on the CPU, on
meshes of repeated CPU devices (``make_mesh(devices=["cpu"] * S)``, the
counterpart of the JAX package's virtual host devices).

Against the port without a mesh: per-pair outputs and FastSMC's output
bytes equal (the plain versions, like the kernels, give a pair the same
bits whatever its batch); sums over pairs within relative 1e-6 (each
shard's sums are rounded to f32 once before the shards are added in
float64). Against the JAX package's ``ShardedDecoder`` and mesh pipelines
on its virtual CPU devices: the tolerances of tests/test_sharding.py
(sums rtol/atol 1e-4, threshold sums rtol 1e-4 atol 1e-5, means rtol 1e-3;
ASMC sums rtol/atol 1e-5, means rtol 1e-5, MAP flips under 1e-3), FastSMC
records equal in their first 9 columns with floats at FLOAT_RTOL 1e-4.
"""

import gzip

import jax
import numpy as np
import pytest
import torch

from fastsmc_tpu.config import DecodingParams as JaxParams
from fastsmc_tpu.io.haps import load_data as jax_load_data
from fastsmc_tpu.parallel import sharding as jax_sharding
from fastsmc_tpu.pipelines.asmc import ASMC as JaxASMC
from fastsmc_tpu.pipelines.fastsmc import FastSMC as JaxFastSMC

import fastsmc_tpu_torch
from fastsmc_tpu_torch.config import DecodingParams
from fastsmc_tpu_torch.engine import segments as seg
from fastsmc_tpu_torch.engine.kernels import BwdOutputs, GpuDecoder
from fastsmc_tpu_torch.io.haps import load_data
from fastsmc_tpu_torch.parallel import (ShardedDecoder, make_mesh,
                                        training_step)
from fastsmc_tpu_torch.pipelines import asmc
from test_torch_host import contexts
from test_torch_pipeline import _assert_same_records, _records

ALL = BwdOutputs(posterior=True, posterior_sums=True, per_pair_mean=True,
                 per_pair_map=True, threshold_sums=True,
                 major_minor_sums=True)
SUMS = ("sum_over_pairs", "sum_over_pairs00", "sum_over_pairs01",
        "sum_over_pairs11")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions run many small ops per site: one intra-op thread
    runs them faster than many, and keeps parallel test workers from
    contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(S):
    return make_mesh(devices=["cpu"] * S)


@pytest.fixture(scope="module")
def ctxs(synthetic_panel_root):
    """(JAX, port) DecodeContext of the 150-sample, 640-site synthetic
    panel (its map is in FastSMC's format)."""
    root, dq, d = synthetic_panel_root
    p = JaxParams.asmc(root, dq, str(d / "ctx"), use_known_seed=True)
    return contexts(p, JaxParams.asmc(root, dq, str(d / "ctx"),
                                      use_known_seed=True, fastsmc=True))


def _pairs(n_haps, P, seed=0):
    rng = np.random.default_rng(seed)
    ha = rng.integers(0, n_haps, P).astype(np.int32)
    return ha, ((ha + 3) % n_haps).astype(np.int32)


@pytest.mark.parametrize("profile", ["exact", "fast"])
def test_sharded_decoder_matches_meshless(ctxs, profile):
    """Every output of a 4-shard decode: per-pair ones bit for bit, the
    sums over pairs within relative 1e-6."""
    _, ctx = ctxs
    ha, hb = _pairs(ctx.data.n_haps, 16)
    got = ShardedDecoder(ctx, cpu_mesh(4), profile).decode_pairs(
        ha, hb, 100, 128, ALL, 11)
    want = GpuDecoder(ctx, "cpu", profile).decode_pairs(ha, hb, 100, 128,
                                                         ALL, 11)
    assert got.keys() == want.keys()
    for name in ("posterior", "per_pair_mean", "per_pair_map",
                 "threshold_sums"):
        assert torch.equal(got[name], want[name]), name
    for name in ("posterior_sums", "major_minor_sums"):
        assert got[name].dtype == torch.float32
        torch.testing.assert_close(got[name], want[name], rtol=1e-6,
                                   atol=0, msg=name)


def test_sharded_decoder_matches_jax_mesh(ctxs):
    """posterior_sums and per_pair_outputs against the JAX package's
    ShardedDecoder on 4 virtual CPU devices (its plain decoder there)."""
    jctx, ctx = ctxs
    assert len(jax.devices()) >= 4
    jsd = jax_sharding.ShardedDecoder(jctx, jax_sharding.make_mesh(4),
                                      use_pallas=False)
    sd = ShardedDecoder(ctx, cpu_mesh(4))
    ha, hb = _pairs(ctx.data.n_haps, 16)
    np.testing.assert_allclose(
        sd.posterior_sums(ha, hb, 100, 128).numpy(),
        np.asarray(jsd.posterior_sums(ha, hb, 100, 128)), rtol=1e-4,
        atol=1e-4)
    th, mean = sd.per_pair_outputs(ha[:8], hb[:8], 200, 64, 10)
    jth, jmean = jsd.per_pair_outputs(ha[:8], hb[:8], 200, 64, 10)
    assert th.shape == (64, 8) and mean.shape == (64, 8)
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-3)


@pytest.mark.parametrize("need_ages", [True, False], ids=["ages", "no-ages"])
def test_decode_extract_packed_merges_to_meshless(ctxs, need_ages):
    """The per-shard packed rows, merged by merge_packed_shards, give the
    meshless extraction's kept runs, scores and age rows; the threshold
    sums come back whole."""
    _, ctx = ctxs
    ha, hb = _pairs(ctx.data.n_haps, 16, seed=1)
    ha[::2] = 4 * np.arange(8)       # identical pairs: long kept runs
    hb[::2] = ha[::2]
    T = 256
    rng = np.random.default_rng(2)
    w0 = rng.integers(0, 64, 16).astype(np.int32)
    w1 = (w0 + rng.integers(64, 192, 16)).astype(np.int32)
    args = (64, T, 11, 0, T, 0.0002, 512, 512, 11, need_ages, w0, w1)
    mesh = cpu_mesh(4)
    packed, ages, th = ShardedDecoder(ctx, mesh).decode_extract_packed(
        ha, hb, *args)
    f_packed, f_ages, f_th = GpuDecoder(ctx, "cpu").decode_extract_packed(
        ha, hb, *args)
    assert packed.shape == (4, 3 * 512 + 2)
    assert torch.equal(th, f_th)
    start, b, score, ns_kept, ns_raw = seg.merge_packed_shards(
        packed.numpy(), T, 4)
    kcap = (len(f_packed) - 2) // 3
    f_start, f_b, f_score, nk, nr = seg.unpack_extract_rows(
        f_packed.numpy(), kcap)
    assert sum(ns_kept) == nk > 0 and max(ns_raw) <= 512 and nr <= 512
    np.testing.assert_array_equal(start, f_start[:nk])
    np.testing.assert_array_equal(b, f_b[:nk])
    np.testing.assert_array_equal(score, f_score[:nk])
    if need_ages:
        merged = np.concatenate([a[:, :n] for a, n in
                                 zip(ages.numpy(), ns_kept)], axis=1)
        np.testing.assert_array_equal(merged, f_ages.numpy()[:, :nk])
    else:
        assert ages is None and f_ages is None


@pytest.mark.parametrize("call", ["decode_pairs", "decode_extract_packed",
                                  "FastSMC", "ASMC"])
def test_batch_not_divisible_by_the_mesh_raises(ctxs, synthetic_panel_root,
                                                call):
    """16 pairs (a batch of 16) on 3 shards."""
    _, ctx = ctxs
    root, dq, d = synthetic_panel_root
    mesh = cpu_mesh(3)
    ha, hb = _pairs(ctx.data.n_haps, 16)
    with pytest.raises(ValueError, match="mesh size 3"):
        if call == "decode_pairs":
            ShardedDecoder(ctx, mesh).decode_pairs(ha, hb, 0, 64)
        elif call == "decode_extract_packed":
            ShardedDecoder(ctx, mesh).decode_extract_packed(
                ha, hb, 0, 64, 11, 0, 64, 0.0002, 512, 512, 11)
        elif call == "FastSMC":
            fastsmc_tpu_torch.FastSMC(DecodingParams.fastsmc_defaults(
                root, dq, str(d / "div"), use_known_seed=True,
                batch_size=16), mesh=mesh)
        else:
            fastsmc_tpu_torch.ASMC(DecodingParams.asmc(
                root, dq, str(d / "div"), use_known_seed=True,
                fastsmc=True), batch_size=16, mesh=mesh)


def test_make_mesh():
    """Without a CUDA device make_mesh() raises (never a CPU mesh by
    default); a device list may repeat a device; a device that names
    another one than the mesh's conflicts."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"] * 2)
    mesh = make_mesh(2, devices=["cpu"] * 4)
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.axis_name == "pairs" and mesh.size == 2
    mesh.check_device("cpu")
    with pytest.raises(ValueError, match="conflicts"):
        mesh.check_device("cuda")


def test_device_conflicting_with_the_mesh_raises(synthetic_panel_root):
    root, dq, d = synthetic_panel_root
    with pytest.raises(ValueError, match="conflicts"):
        fastsmc_tpu_torch.FastSMC(DecodingParams.fastsmc_defaults(
            root, dq, str(d / "conflict"), use_known_seed=True,
            batch_size=16), device="cuda", mesh=cpu_mesh(2))


def test_training_step_runs(ctxs):
    _, ctx = ctxs
    step, args = training_step(ctx, cpu_mesh(4))
    assert len(args[0]) == 8
    out = step(*args)
    assert out.shape == (64, ctx.dq.states)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(1).numpy(), 8.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the pipelines on a mesh
# ---------------------------------------------------------------------------

def _fastsmc(root, dq, out, mesh=None, caps=None, data=None, **kw):
    kw.setdefault("batch_size", 16)
    f = fastsmc_tpu_torch.FastSMC(
        DecodingParams.fastsmc_defaults(root, dq, out, use_known_seed=True,
                                        min_m=0.5, **kw),
        data=data, device=None if mesh else "cpu", mesh=mesh)
    if caps:
        f._seg_cap = f._kept_cap = f._pps_cap = caps
    path = f.run(verbose=False)
    with gzip.open(path, "rb") as fh:
        return f, path, fh.read()


@pytest.mark.parametrize("S,caps", [(1, None), (2, None), (4, None), (4, 8)],
                         ids=["S1", "S2", "S4", "S4-caps8"])
def test_fastsmc_mesh_writes_the_meshless_bytes(synthetic_panel_root, S,
                                                caps):
    """FastSMC over S shards writes the meshless run's bytes; with every
    cap started at 8, shards overflow and their batches are redone."""
    root, dq, d = synthetic_panel_root
    _, _, want = _fastsmc(root, dq, str(d / "meshless"))
    f, _, got = _fastsmc(root, dq, str(d / f"mesh{S}_{caps}"), cpu_mesh(S),
                         caps)
    assert want.count(b"\n") > 0 and got == want
    if caps:
        assert f.stats["overflow_redos"] > 0


@pytest.mark.parametrize("S,bs", [(4, 16), (8, 16), (8, 4096)],
                         ids=["S4", "S8", "S8-floor"])
def test_fastsmc_mesh_matches_jax_mesh(synthetic_panel_root, S, bs):
    """The records of the JAX package's FastSMC on S virtual devices, and
    its decoded site-pairs: at S=8 the pad floor is 2048, so a batch of
    4,096 candidates shrinks to 2,048 pairs, not to 1,024."""
    root, dq, d = synthetic_panel_root
    jf = JaxFastSMC(JaxParams.fastsmc_defaults(
        root, dq, str(d / f"jax_mesh{S}_{bs}"), use_known_seed=True,
        min_m=0.5, batch_size=bs), use_pallas=False,
        mesh=jax_sharding.make_mesh(S))
    want = _records(jf.run(verbose=False))
    f, path, _ = _fastsmc(root, dq, str(d / f"port_mesh{S}_{bs}"),
                          cpu_mesh(S), batch_size=bs)
    assert want
    _assert_same_records(_records(path), want)
    assert f.stats["decoded_site_pairs"] == jf.stats["decoded_site_pairs"]
    if bs > 2048:
        assert f._pad_floor == 2048
        assert f.stats["decoded_site_pairs"] % 2048 == 0


def test_fastsmc_no_hashing_mesh_writes_the_meshless_bytes(
        synthetic_panel_root):
    """Without hashing (job 1 of 900 of the whole panel's pairs: 49, in
    batches of 48 and 1, with the planted pair of haplotypes 7 and 8) the
    last batch is padded to the 4-shard mesh with copies of its last pair,
    whose runs are dropped."""
    root, dq, d = synthetic_panel_root
    data = load_data(DecodingParams.asmc(root, dq, str(d / "nohash"),
                                         use_known_seed=True, fastsmc=True))
    kw = dict(hashing=False, jobs=900, job_ind=1, batch_size=48, data=data)
    _, _, want = _fastsmc(root, dq, str(d / "nohash"), **kw)
    f, _, got = _fastsmc(root, dq, str(d / "nohash_mesh"), cpu_mesh(4), **kw)
    assert f._cpt == 49 and want.count(b"\n") > 0 and got == want


def _asmc(root, dq, out, mesh=None, jax=False):
    """The synthetic panel's 150 within-sample pairs, batch 64 (the last
    batch 22 pairs: 20 on the mesh, 2 on its first device), both sums and
    the per-pair streams."""
    P = JaxParams if jax else DecodingParams
    p = P.asmc(root, dq, out, do_posterior_sums=True,
               do_major_minor_posterior_sums=not jax,
               do_per_pair_posterior_mean=True, do_per_pair_map=True,
               within_only=True, use_known_seed=True, fastsmc=True)
    data = (jax_load_data if jax else load_data)(p)
    p.fastsmc = False
    if jax:
        a = JaxASMC(p, data=data, use_pallas=False, batch_size=64,
                    mesh=mesh)
    else:
        a = asmc.ASMC(p, data=data, device=None if mesh else "cpu",
                      batch_size=64, mesh=mesh)
    res = a.decode_all_in_job(verbose=False)
    streams = []
    for kind in ("perPairPosteriorMeans", "perPairMAP"):
        with gzip.open(f"{out}.{kind}.gz", "rb") as fh:
            streams.append(fh.read())
    return a, res, streams


def test_asmc_mesh_matches_meshless_and_jax(synthetic_panel_root):
    """decode_all_in_job on 4 shards: the per-pair streams' bytes and the
    sums (relative 1e-6) of the meshless run, two runs byte-identical, and
    the JAX package's mesh run at its gates."""
    root, dq, d = synthetic_panel_root
    _, want, want_streams = _asmc(root, dq, str(d / "asmc_meshless"))
    a, got, streams = _asmc(root, dq, str(d / "asmc_mesh"), cpu_mesh(4))
    _, again, again_streams = _asmc(root, dq, str(d / "asmc_mesh2"),
                                    cpu_mesh(4))
    assert isinstance(a.decoder, ShardedDecoder)
    assert streams == want_streams == again_streams
    for f in SUMS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-6, atol=0, err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(again, f))
    _, jres, _ = _asmc(root, dq, str(d / "asmc_jax_mesh"),
                       jax_sharding.make_mesh(4), jax=True)
    np.testing.assert_allclose(got.sum_over_pairs, jres.sum_over_pairs,
                               rtol=1e-5, atol=1e-5)
    means = np.loadtxt(str(d / "asmc_mesh") + ".perPairPosteriorMeans.gz")
    jmeans = np.loadtxt(str(d / "asmc_jax_mesh")
                        + ".perPairPosteriorMeans.gz")
    np.testing.assert_allclose(means, jmeans, rtol=1e-5)
    maps = np.loadtxt(str(d / "asmc_mesh") + ".perPairMAP.gz")
    jmaps = np.loadtxt(str(d / "asmc_jax_mesh") + ".perPairMAP.gz")
    assert (maps != jmaps).mean() < 1e-3


def test_asmc_decode_pairs_on_a_mesh(synthetic_panel_root):
    """The targeted-pair API pads 3 pairs to the 4-shard mesh and returns
    the meshless posteriors' means and MAP states."""
    root, dq, d = synthetic_panel_root
    p = DecodingParams.asmc(root, dq, str(d / "api"), use_known_seed=True,
                            fastsmc=True)
    data = load_data(p)
    ha, hb = [0, 10, 200], [1, 31, 201]
    got = asmc.ASMC(p, data=data, mesh=cpu_mesh(4), batch_size=64
                    ).decode_pairs(ha, hb)
    want = asmc.ASMC(p, data=data, device="cpu", batch_size=64
                     ).decode_pairs(ha, hb)
    np.testing.assert_array_equal(got.per_pair_posterior_means,
                                  want.per_pair_posterior_means)
    np.testing.assert_array_equal(got.per_pair_maps, want.per_pair_maps)
