"""The alpha-wall probe's plain versions (fastsmc_tpu_torch.probes.
alpha_wall) against the probe's two Pallas kernels in interpret mode on
the CPU.

The kernels of scripts/alpha_wall_probe.py are closures inside its main(),
which refuses the CPU backend (:40), so they cannot be called from here.
This file holds a verbatim copy of their bodies (make_fwd :74-108, make_bwd
:137-155) and of their launches (:113-134, :157-181), with the shapes as
parameters, one change and one addition: the backward kernel's carry
starts at 1/KC at the first grid step (the probe leaves it uninitialised;
interpret mode starts it as NaN), and where asked it also writes its raw
carry after one site to a second output, so that the plain version's
carry is held to the JAX kernel's too. Both sides get the same inputs, made once with numpy;
the bf16 operators go to JAX as the f32 values of the port's bf16 tensor,
so that neither side rounds f64 to bf16 on its own.

Tolerance: the two sides multiply the same bf16 operands exactly and sum
in f32 in another order; the carry is rounded to bf16 again at every site,
so a carry one f32 bit apart could round the other way and the two would
drift at bf16 level. At this size they do not. Both outputs are compared
raw, element by element, relative to the plain version's value (every
value is a sum of positive products): alpha (bf16 on both sides) reads 0,
the backward output 3.3e-7. Gate: rtol 1e-5. A forward that normalises at
the wrong sites or by the wrong sum reads 0.77-3.7e3 on the same measure
(test_gate_rejects_wrong_normalisation). Block against per-site
normalisation is the same function up to each column's scale: after each
site's column is divided by its sum, alpha reads 8.3e-3 (one bf16 step) and
the backward output 2.8e-4; gates rtol 2e-2 and 2e-3.

The backward output is renormalised per column, so it cannot show where
the backward normalises; its raw carry after a site inside a block can
(test_backward_carry_gate_rejects_every_site_normalisation, with the
card's gate on it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fastsmc_tpu_torch.engine import kernels
from fastsmc_tpu_torch.probes import alpha_wall as aw

RTOL = 1e-5
NORM_RTOL = {"fwd": 2e-2, "bwd": 2e-3}
# the probe's backward kernel's raw carry against the plain version's on the
# card (chip_smoke.py's ALPHA_WALL_CARRY_RTOL), held after CARRY_SITE: not a
# backward block end (r % S == 0) at any S > 1
CARRY_RTOL = 1.6e-2
CARRY_SITE = 1
SMALL = aw.Shape(KC=16, KA=9, S=4, P=40, T=32, G=5)
# KA=9 sums every stored row into the backward output (which is then 1);
# KA=12 keeps the first-10-rows sum a real fraction
SHAPES = {"KA=9": SMALL, "KA=12": aw.Shape(KC=16, KA=12, S=4, P=40, T=32,
                                           G=5)}


# ---------------------------------------------------------------------------
# the probe's kernels (scripts/alpha_wall_probe.py), shapes as parameters
# ---------------------------------------------------------------------------

def _pallas_probe(shape, M, em, obs, isp, ops_idx, alpha_in):
    KC, KA, S, P, T = shape.KC, shape.KA, shape.S, shape.P, shape.T
    nblk = T // S
    cdt = jnp.bfloat16
    adt = jnp.bfloat16
    alpha_small = alpha_in[:nblk]

    def emission(em_ref, obs_ref, i):
        e = em_ref[i]
        o = obs_ref[i]
        return (e[0][:, None] + e[1][:, None] * o[0][None, :]
                + e[2][:, None] * o[1][None, :])

    def dot(m, v):
        return jnp.dot(m, v.astype(cdt), preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.DEFAULT)

    def make_fwd(store_every, norm_block=False):
        def kernel(ops_ref, *rest):
            m = rest[:S]
            em_ref, obs_ref, isp_ref, alpha_ref, carry = rest[S:]
            t = pl.program_id(0)

            def norm(c, i):
                if norm_block and i != S - 1:
                    return c
                return c / jnp.sum(c, axis=0, keepdims=True)

            for i in range(S):
                if i == 0:
                    @pl.when(t == 0)
                    def _():
                        c = isp_ref[0][:, None] * emission(em_ref, obs_ref, 0)
                        carry[:] = norm(c, 0)

                    @pl.when(t > 0)
                    def _():
                        c = dot(m[0][0], carry[:]) \
                            * emission(em_ref, obs_ref, 0)
                        carry[:] = norm(c, 0)
                else:
                    c = dot(m[i][0], carry[:]) * emission(em_ref, obs_ref, i)
                    carry[:] = norm(c, i)
                if store_every or i == S - 1:
                    alpha_ref[i if store_every else 0] = \
                        carry[:KA].astype(adt)
        return kernel

    def blk(t, *a):
        return (t, 0, 0)

    def run_fwd(store_every, norm_block=False):
        op_specs = [pl.BlockSpec((1, KC, KC),
                                 lambda t, ops, i=i: (ops[S * t + i], 0, 0))
                    for i in range(S)]
        rows = S if store_every else 1
        grid = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nblk,),
            in_specs=op_specs + [
                pl.BlockSpec((S, 3, KC), blk),
                pl.BlockSpec((S, 2, P), blk),
                pl.BlockSpec((1, KC), lambda t, *a: (0, 0))],
            out_specs=pl.BlockSpec((rows, KA, P),
                                   (blk if store_every
                                    else (lambda t, *a: (t, 0, 0)))),
            scratch_shapes=[pltpu.VMEM((KC, P), jnp.float32)])
        shape_ = (T, KA, P) if store_every else (nblk, KA, P)
        f = pl.pallas_call(make_fwd(store_every, norm_block),
                           grid_spec=grid,
                           out_shape=jax.ShapeDtypeStruct(shape_, adt),
                           interpret=True)
        return f(ops_idx, *([M] * S), em, obs, isp)

    def make_bwd(read_every, norm_block=False, carry_site=None):
        def kernel(ops_ref, *rest):
            m = rest[:S]
            if carry_site is None:
                em_ref, obs_ref, alpha_ref, out_ref, carry = rest[S:]
            else:
                em_ref, obs_ref, alpha_ref, out_ref, kept_ref, carry = \
                    rest[S:]
            t = pl.program_id(0)

            # the one change: the probe never initialises its carry
            @pl.when(t == 0)
            def _():
                carry[:] = jnp.full(carry.shape, 1.0 / KC, jnp.float32)

            for i in range(S):
                r = S - 1 - i
                c = dot(m[i][0], carry[:] * emission(em_ref, obs_ref, r))
                if norm_block and i != S - 1:
                    carry[:] = c
                else:
                    carry[:] = c / jnp.sum(c, axis=0, keepdims=True)
                if carry_site is not None and r == carry_site % S:
                    # the copy's addition: the raw carry after carry_site
                    @pl.when(nblk - 1 - t == carry_site // S)
                    def _():
                        kept_ref[:] = carry[:]
                a = alpha_ref[r if read_every else 0].astype(jnp.float32)
                post = a * (c[:KA] if norm_block else carry[:KA])
                post = post / jnp.sum(post, axis=0, keepdims=True)
                out_ref[r, 0] = jnp.sum(
                    jnp.where(jax.lax.broadcasted_iota(
                        jnp.int32, post.shape, 0) < 10, post, 0.0), axis=0)
        return kernel

    def run_bwd(read_every, norm_block=False, carry_site=None):
        def rev(t, *a):
            return (nblk - 1 - t, 0, 0)
        op_specs = [pl.BlockSpec(
            (1, KC, KC), lambda t, ops, i=i: (ops[T - 1 - (S * t + i)], 0, 0))
            for i in range(S)]
        rows = S if read_every else 1
        grid = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(nblk,),
            in_specs=op_specs + [
                pl.BlockSpec((S, 3, KC), rev),
                pl.BlockSpec((S, 2, P), rev),
                pl.BlockSpec((rows, KA, P),
                             rev if read_every else (lambda t, *a:
                                                     (nblk - 1 - t, 0, 0)))],
            out_specs=pl.BlockSpec((S, 1, P), rev) if carry_site is None
            else [pl.BlockSpec((S, 1, P), rev),
                  pl.BlockSpec((KC, P), lambda t, *a: (0, 0))],
            scratch_shapes=[pltpu.VMEM((KC, P), jnp.float32)])
        src = alpha_in if read_every else alpha_small
        out_shape = jax.ShapeDtypeStruct((T, 1, P), jnp.float32)
        if carry_site is not None:
            out_shape = [out_shape,
                         jax.ShapeDtypeStruct((KC, P), jnp.float32)]
        f = pl.pallas_call(make_bwd(read_every, norm_block, carry_site),
                           grid_spec=grid, out_shape=out_shape,
                           interpret=True)
        return f(ops_idx, *([M] * S), em, obs, src)

    return {"fwd": run_fwd, "bwd": run_bwd}


@functools.lru_cache(maxsize=None)
def _inputs(shape):
    """The port's inputs (CPU tensors) and the same bits as JAX arrays."""
    inp = aw.make_inputs(shape, "cpu", seed=3)
    jx = dict(M=jnp.asarray(inp["M"].float().numpy(), jnp.bfloat16),
              em=jnp.asarray(inp["em"].numpy()),
              obs=jnp.asarray(inp["obs"].numpy()),
              isp=jnp.asarray(inp["isp"].numpy()[None, :]),
              ops_idx=jnp.asarray(inp["ops"].numpy()),
              alpha_in=jnp.asarray(inp["alpha"].float().numpy(),
                                   jnp.bfloat16))
    assert np.array_equal(np.asarray(jx["M"]).astype(np.float32),
                          inp["M"].float().numpy())
    return inp, jx


def _columns_normalised(x):
    return x / x.sum(dim=1, keepdim=True)


def _forward_normalised_at(inp, shape, norm_site, rows):
    """The probe's forward, storing every site, with the carry divided by
    the sum of its first ``rows`` rows at the sites where
    ``norm_site(t)`` holds: the plain version's arithmetic, for forwards
    that normalise in the wrong place."""
    Mf, ops = inp["M"].float(), inp["ops"].tolist()
    alpha = torch.empty((shape.T, shape.KA, shape.P), dtype=torch.bfloat16)
    for t in range(shape.T):
        e = kernels._emission(inp["em"][t], inp["obs"][t])
        c = inp["isp"][:, None] * e if t == 0 else \
            (Mf[ops[t]] @ kernels._bf16(c)) * e
        if norm_site(t):
            c = c / c[:rows].sum(dim=0, keepdim=True)
        alpha[t] = c[:shape.KA]
    return alpha


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("name", list(aw.VARIANTS))
def test_plain_versions_match_pallas_interpret(name, shape_id):
    shape = SHAPES[shape_id]
    inp, jx = _inputs(shape)
    kind, every, norm_block = aw.VARIANTS[name]
    want = np.asarray(_pallas_probe(shape, **jx)[kind](every, norm_block)
                      ).astype(np.float32)
    got = aw.run_variant(name, inp, shape, plain=True).float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert (want > 0).all()
    if kind == "fwd":
        assert got.shape[0] == (shape.T if every else shape.T // shape.S)
    else:
        assert got.shape == (shape.T, 1, shape.P)
        assert (got <= 1 + 1e-6).all()
        if shape.KA <= aw.POST_ROWS:
            np.testing.assert_allclose(got, 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# the card kernel's edges: a ragged last m-tile (P=37: 2 tiles of 16 and 5
# pairs), the carry at the backward pass's first site (T-1), at a block end
# (S: normalised under block normalisation) and at the last site (0)
RAGGED = aw.Shape(KC=16, KA=12, S=4, P=37, T=32, G=5)


@pytest.mark.parametrize("carry_site", [0, RAGGED.S, RAGGED.T - 1])
@pytest.mark.parametrize("name", [n for n, v in aw.VARIANTS.items()
                                  if v[0] == "bwd"])
def test_backward_carry_matches_pallas_interpret_at_ragged_P(name,
                                                             carry_site):
    """The plain backward's output and raw carry after ``carry_site`` at
    P=37 against the Pallas copy's, at the measure and gate of
    test_plain_versions_match_pallas_interpret (relative, RTOL)."""
    shape = RAGGED
    inp, jx = _inputs(shape)
    _, every, norm_block = aw.VARIANTS[name]
    want, want_carry = (np.asarray(x) for x in _pallas_probe(shape, **jx)[
        "bwd"](every, norm_block, carry_site))
    got, carry = aw.run_variant(name, inp, shape, plain=True,
                                carry_site=carry_site)
    assert carry.shape == (shape.KC, shape.P) and (want_carry > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(carry.numpy(), want_carry, rtol=RTOL, atol=0)


def test_norm_block_changes_only_the_scale():
    """Under block normalisation the forward stores the same columns up to
    their scale and the backward gives the same output (exact in exact
    arithmetic; bf16-level here). The scale itself differs: the raw
    alphas are far apart."""
    for shape in SHAPES.values():
        inp, _ = _inputs(shape)
        a, b = (aw.run_variant(n, inp, shape, plain=True).float()
                for n in ("fwd_store", "fwd_norm_block"))
        torch.testing.assert_close(_columns_normalised(b),
                                   _columns_normalised(a),
                                   rtol=NORM_RTOL["fwd"], atol=0)
        assert aw.max_errors(b, a)[1] > 1
        a, b = (aw.run_variant(n, inp, shape, plain=True)
                for n in ("bwd_read", "bwd_norm_block"))
        torch.testing.assert_close(b, a, rtol=NORM_RTOL["bwd"], atol=0)


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_gate_rejects_wrong_normalisation(shape_id):
    """Forwards that normalise where the probe does not, held to the plain
    version by the measure the kernels are held to: each misses it by far
    (readings 0.77-3.7e3 here), while the same arithmetic normalising where
    the probe does reproduces the plain version bit for bit."""
    shape = SHAPES[shape_id]
    inp, _ = _inputs(shape)
    S, KA, KC = shape.S, shape.KA, shape.KC
    block = aw.run_variant("fwd_norm_block", inp, shape, plain=True)
    every = aw.run_variant("fwd_store", inp, shape, plain=True)
    assert torch.equal(_forward_normalised_at(
        inp, shape, lambda t: t % S == S - 1, KC), block)
    assert torch.equal(_forward_normalised_at(inp, shape, lambda t: True,
                                              KC), every)
    wrong = {
        "ignores NORM_BLOCK": (every, block),
        "normalises each block's first site": (_forward_normalised_at(
            inp, shape, lambda t: t % S == 0, KC), block),
        "divides by the stored rows' sum": (_forward_normalised_at(
            inp, shape, lambda t: True, KA), every)}
    for what, (got, want) in wrong.items():
        assert aw.max_errors(got, want)[1] > 0.5, what


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_backward_carry_gate_rejects_every_site_normalisation(shape_id):
    """The raw carry of bwd_norm_block after CARRY_SITE, held as the card
    holds the kernel's (element by element, relative, CARRY_RTOL): a wrong
    plain version that normalises at every site under block normalisation
    (bwd_read's arithmetic) misses that gate by far (reading 1.8e3 here),
    while its output stays within bf16 level of the right one's, so only
    the carry tells them apart. The two carries, each column divided by its
    sum, agree at bf16 level (1.1e-3; 1.3e-3 at a block end). Asking for
    the carry changes no output bit."""
    shape = SHAPES[shape_id]
    inp, _ = _inputs(shape)
    out, carry = aw.run_variant("bwd_norm_block", inp, shape, plain=True,
                                carry_site=CARRY_SITE)
    w_out, wrong = aw.run_variant("bwd_read", inp, shape, plain=True,
                                  carry_site=CARRY_SITE)
    assert torch.equal(out, aw.run_variant("bwd_norm_block", inp, shape,
                                           plain=True))
    assert carry.shape == (shape.KC, shape.P) and (carry > 0).all()
    assert aw.max_errors(wrong, carry)[1] > 10 * CARRY_RTOL
    torch.testing.assert_close(w_out, out, rtol=NORM_RTOL["bwd"], atol=0)
    torch.testing.assert_close(carry / carry.sum(dim=0, keepdim=True), wrong,
                               rtol=NORM_RTOL["bwd"], atol=0)
    # at a block end the two carries are both normalised
    _, a = aw.run_variant("bwd_norm_block", inp, shape, plain=True,
                          carry_site=shape.S)
    _, b = aw.run_variant("bwd_read", inp, shape, plain=True,
                          carry_site=shape.S)
    assert aw.max_errors(a, b)[1] <= NORM_RTOL["bwd"]


def test_nostore_keeps_each_blocks_last_site():
    inp, _ = _inputs(SMALL)
    a = aw.run_variant("fwd_store", inp, SMALL, plain=True)
    b = aw.run_variant("fwd_nostore", inp, SMALL, plain=True)
    assert torch.equal(a[SMALL.S - 1::SMALL.S], b)


def test_wrappers_take_plain_versions_on_cpu():
    inp, _ = _inputs(SMALL)
    before = dict(kernels.LAUNCHES)
    for name in aw.VARIANTS:
        got = aw.run_variant(name, inp, SMALL)
        want = aw.run_variant(name, inp, SMALL, plain=True)
        assert torch.equal(got, want), name
    got = aw.run_variant("bwd_read", inp, SMALL, carry_site=CARRY_SITE)
    want = aw.run_variant("bwd_read", inp, SMALL, plain=True,
                          carry_site=CARRY_SITE)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert dict(kernels.LAUNCHES) == before


def test_probe_on_the_card_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        aw.probe(SMALL, "cuda", reps=1)


def test_probe_main_on_the_cpu(tmp_path, capsys):
    """The probe's main at a tiny shape on the CPU (the plain versions, host
    clock): six variants timed, the write and read costs, JSON where
    asked."""
    out = tmp_path / "aw.json"
    res = aw.main(["--device", "cpu", "--reps", "2", "--out", str(out)],
                  shape=SHAPES["KA=12"])
    text = capsys.readouterr().out
    assert out.exists() and set(res["ms"]) == set(aw.VARIANTS)
    assert res["device"] == "cpu" and res["timer"] == "host clock"
    assert "alpha write" in text.lower() and "alpha read" in text.lower()
    assert all(len(v) == 2 for v in res["ms_all"].values())
    assert res["alpha_GB_per_pass"] == 32 * 12 * 40 * 2 / 1e9
