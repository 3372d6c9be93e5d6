"""PyTorch port: ensembles with f64 directions through the batched kernels.

With f64 directions (`solve_ensemble_host(direction_dtype=None)`) the
reference vmaps `jax.jvp` of its f64 F (`hank_tpu/parallel/ensemble.py:
247-279`). The port's kernel route (`fused="auto"` on the card, "pallas" on
any device) takes the batched f64 tangent sweep for the one-asset family
(`ops/fused_sweep_batch.make_fused_jvp_batch(..., f64)`) and the batched f64
tangent pair for the two-asset family (`ops/fused_sweep2.make_fused2_jvp_batch(
..., f64)`), and F_b through the batched kernel 2 or the batched f64
residual pair. On the CPU the kernels run their plain versions. On the
small Krusell-Smith (40×5, T=12) and the small two-asset model (24×12×4×2,
T=12; `tests/test_torch_fused2_f64.py`'s `Case`), from the JAX steady
states carried across, with inputs from a numpy seed, this file holds:
  (a) each batched f64 map's plain version, row by row, against `jax.jvp`
      of the JAX package's f64 F at the same (x_b, v_b, shocks), B = 3, to
      1e-12 of the largest |ref|, and bit for bit against the single-path
      f64 map's plain version;
  (b) the route `fused` picks, by the plain versions' call counters and
      the plain F's: "auto" with a state that reports itself on the card
      (`OnCard`), "pallas" on CPU tensors, "xla", and "auto" on CPU tensors;
  (c) a one-asset f64 Newton-Krylov ensemble solve through `fused="pallas"`
      against the JAX package's `solve_ensemble_host(direction_dtype=None,
      fused="xla")`: the same outers, roots within 1e-9;
  (d) the builds past each new count raise ValueError naming `fused='xla'`
      (the libraries' counts transcribed, or replaced, as
      `tests/test_torch_kernel_fit.py` does), and the tiers before it.
The kernels run only on a card (`gpu` marker): there every row of each
batched f64 kernel is held bit for bit to a single launch, and the one-asset
one to the counting template's `<double, true, true>`. Those tests import
neither JAX nor `tests/conftest.py` (their seeded inputs come from the
JAX-free card tests of `test_torch_sweep_bits.py` and
`test_torch_fused2_batch.py`, by module name: pytest puts `tests/` on the
path):
`python -m pytest --noconftest -m gpu tests/test_torch_ensemble_f64_directions.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hank_tpu_torch.parallel.ensemble as ens
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_residual as fr
from hank_tpu_torch.ops import fused_residual2 as fr2
from hank_tpu_torch.ops import fused_sweep as fs
from hank_tpu_torch.ops import fused_sweep2 as fs2
from hank_tpu_torch.ops import fused_sweep_batch as fsb

torch.set_num_threads(1)
f64 = torch.float64
RTOL = 1e-12
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
KEYS = ("B", "A", "C")


def to_torch(a, dtype=f64) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype)


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), as the
    routes and the builds ask; the wrappers look at `device` and run their
    plain versions."""

    @property
    def is_cuda(self):
        return True


def on_card(ss):
    return dataclasses.replace(ss, value=ss.value.as_subclass(OnCard))


class KS:
    """The small KS in both packages, its steady state, x_ss and J̄."""

    def __init__(self, jm, jss):
        from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac

        from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
        from tests.test_torch_common import build_small_ks_torch, ss_to_numpy
        from tests.test_torch_solve import x_ss_of

        self.jm, self.jss = jm, jss
        self.tm = build_small_ks_torch(T=jm.compspec.T)
        self.tss = steady_state_from_numpy(ss_to_numpy(jss), device="cpu")
        self.x_ss = x_ss_of(jm, jss)
        self.J = np.asarray(jjac(jss, jm))
        t = np.arange(1, jm.compspec.T, dtype=np.float64)
        self.shocks = {"Z": 1.0 + 0.05 * np.array([0.5, 0.7, 0.9])[:, None] ** t[None, :]}


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    return KS(ks_small, ks_small_ss)


@pytest.fixture(scope="module")
def two():
    from tests.test_torch_fused2_f64 import Case

    case = Case()
    t = np.arange(1, case.tm.compspec.T, dtype=np.float64)
    case.shocks = {"G": np.array([0.005, 0.0075, 0.01])[:, None]
                   * np.array([0.5, 0.7, 0.8])[:, None] ** t[None, :]}
    return case


def points(x_ss, B: int, seed: int):
    rng = np.random.default_rng(seed)
    x_b = x_ss[None] * (1.0 + 0.002 * rng.normal(size=(B, x_ss.shape[0])))
    return x_b, rng.normal(size=(B, x_ss.shape[0]))


PLAIN_F_CALLS = [0]


@pytest.fixture(autouse=True)
def count_plain_residual(monkeypatch):
    """Count the plain f64 F's evaluations by the ensemble's routes (which
    take it by `parallel.ensemble.make_full_residual_fn`)."""
    plain = ens.make_full_residual_fn

    def counted_residual(*a):
        F = plain(*a)

        def counted(x):
            PLAIN_F_CALLS[0] += 1
            return F(x)

        return counted

    monkeypatch.setattr(ens, "make_full_residual_fn", counted_residual)


def kernel_calls():
    """Calls of the plain versions of the kernel route's batched kernels:
    the one-asset f64 tangent sweep and kernel 2, the two-asset tangent
    pair and f64 residual pair."""
    return {"jvp_f64_batch": fsb.fused_sweep_jvp_f64_batch_reference.calls,
            "k2_batch": fr.fused_residual_sweep_batch_reference.calls,
            "pair_jvp_f64": (fs2.fused2_policies_jvp_f64_batch_reference.calls,
                             fs2.fused2_forward_jvp_f64_batch_reference.calls),
            "pair_f64": (fr2.fused2_policies_f64_batch_reference.calls,
                         fr2.fused2_forward_f64_batch_reference.calls)}


def counted_since(before) -> dict:
    now = kernel_calls()
    out = {}
    for k, v in now.items():
        out[k] = (tuple(a - b for a, b in zip(v, before[k])) if isinstance(v, tuple)
                  else v - before[k])
    return out


# ── (a) the batched f64 maps' plain versions ──────────────────────────────

def test_one_asset_batched_f64_map_matches_jax_jvp_and_the_single_path_map(ks):
    import jax
    import jax.numpy as jnp
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake_F

    x_b, v_b = points(ks.x_ss, 3, 0)
    exog_b = {k: to_torch(v) for k, v in ks.shocks.items()}
    calls = fsb.fused_sweep_jvp_f64_batch_reference.calls
    out = fsb.make_fused_jvp_batch(ks.tm, ks.tss, ks.tss, f64)(to_torch(x_b), to_torch(v_b),
                                                               exog_b)
    assert fsb.fused_sweep_jvp_f64_batch_reference.calls == calls + 1
    assert out.dtype == f64 and out.shape == x_b.shape
    for b in range(3):
        jF = jmake_F(ks.jm, ks.jss, ks.jss, {"Z": jnp.asarray(ks.shocks["Z"][b])})
        ref = np.asarray(jax.jvp(jF, (jnp.asarray(x_b[b]),), (jnp.asarray(v_b[b]),))[1])
        assert float(np.max(np.abs(out[b].numpy() - ref))) <= RTOL * float(np.max(np.abs(ref)))
        single = fs.make_fused_jvp_dir_f64(ks.tm, ks.tss, ks.tss, {"Z": exog_b["Z"][b]})
        assert torch.equal(out[b], single(to_torch(x_b[b]), to_torch(v_b[b]))), b


def test_two_asset_batched_f64_map_matches_jax_jvp_and_the_single_path_map(two):
    import jax
    import jax.numpy as jnp
    from hank_tpu.solvers.newton import make_full_residual_fn as jmake_F

    x_b, v_b = points(two.x_ss, 3, 1)
    exog_b = {k: to_torch(v) for k, v in two.shocks.items()}
    calls = (fs2.fused2_policies_jvp_f64_batch_reference.calls,
             fs2.fused2_forward_jvp_f64_batch_reference.calls)
    out = fs2.make_fused2_jvp_batch(two.tm, two.tss, two.tss, f64)(to_torch(x_b), to_torch(v_b),
                                                                  exog_b)
    assert (fs2.fused2_policies_jvp_f64_batch_reference.calls,
            fs2.fused2_forward_jvp_f64_batch_reference.calls) == (calls[0] + 1, calls[1] + 1)
    assert out.dtype == f64 and out.shape == x_b.shape
    for b in range(3):
        jF = jmake_F(two.jm, two.jss, two.jss, {"G": jnp.asarray(two.shocks["G"][b])})
        ref = np.asarray(jax.jvp(jF, (jnp.asarray(x_b[b]),), (jnp.asarray(v_b[b]),))[1])
        assert float(np.max(np.abs(out[b].numpy() - ref))) <= RTOL * float(np.max(np.abs(ref)))
        single = fs2.make_fused2_jvp_dir_f64(two.tm, two.tss, two.tss, {"G": exog_b["G"][b]})
        assert torch.equal(out[b], single(to_torch(x_b[b]), to_torch(v_b[b]))), b


# ── (b) the route `fused` picks ───────────────────────────────────────────

ROUTES = [  # fused, state on the card, kernel route
    ("auto", True, True), ("pallas", False, True), ("xla", False, False),
    ("xla", True, False), ("auto", False, False)]


def one_outer(case, fused, card, dtype=None):
    ss = on_card(case.tss) if card else case.tss
    exog_b = {k: to_torch(v[:2]) for k, v in case.shocks.items()}
    before, plain = kernel_calls(), PLAIN_F_CALLS[0]
    _, info = ens.solve_ensemble_host(to_torch(case.x_ss), to_torch(case.J), exog_b, case.tm, ss,
                                      ss, eps=1e-10, method="newton_krylov", direction_dtype=dtype,
                                      fused=fused, max_outer=1, gmres_m=2)
    assert info["iterations"] == 1
    return counted_since(before), PLAIN_F_CALLS[0] - plain


@pytest.mark.parametrize("fused,card,kernels", ROUTES)
def test_fused_picks_the_one_asset_route(ks, monkeypatch, fused, card, kernels):
    """The kernel route launches (here: calls the plain versions of) the
    batched f64 tangent sweep and the batched kernel 2 and no plain F; the
    plain route the plain F and neither kernel. On the card every tier fits
    one block (the library's count replaced)."""
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: 0)
    got, plain = one_outer(ks, fused, card)
    if kernels:
        assert got["jvp_f64_batch"] > 0 and got["k2_batch"] > 0 and plain == 0
    else:
        assert got["jvp_f64_batch"] == 0 and got["k2_batch"] == 0 and plain > 0


@pytest.mark.parametrize("fused,card,kernels", ROUTES)
def test_fused_picks_the_two_asset_route(two, monkeypatch, fused, card, kernels):
    """The same for the two-asset family: the batched tangent pair for the
    directions and the batched f64 residual pair for F_b."""
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", lambda *a, **k: SMEM)
    got, plain = one_outer(two, fused, card)
    if kernels:
        assert min(got["pair_jvp_f64"]) > 0 and min(got["pair_f64"]) > 0 and plain == 0
    else:
        assert got["pair_jvp_f64"] == (0, 0) and got["pair_f64"] == (0, 0) and plain > 0


def test_fused_takes_the_f32_kernels_and_refuses_a_model_without_them(ks, monkeypatch):
    """With f32 directions "pallas" takes kernels 3-4 and "xla" the
    mixed-tail map; "pallas" needs one of the two families' hooks, and an
    unknown `fused` raises."""
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: 0)
    for fused, kernels in (("pallas", True), ("xla", False)):
        calls = fsb.fused_sweep_jvp_batch_reference.calls
        got, plain = one_outer(ks, fused, False, torch.float32)
        assert (fsb.fused_sweep_jvp_batch_reference.calls > calls) == kernels
        assert (got["k2_batch"] > 0, plain > 0) == (kernels, not kernels)
    value_fn = ks.tm.value_fn
    other = dataclasses.replace(ks.tm, value_fn=lambda *a: value_fn(*a))
    args = (to_torch(ks.x_ss), to_torch(ks.J), {"Z": to_torch(ks.shocks["Z"][:2])}, other,
            ks.tss, ks.tss)
    with pytest.raises(ValueError, match="fused='pallas' needs"):
        ens.solve_ensemble_host(*args, fused="pallas", direction_dtype=None)
    with pytest.raises(ValueError, match="expected 'auto'"):
        ens.solve_ensemble_host(*args, fused="mosaic")
    _, info = ens.solve_ensemble_host(*args, fused="xla", direction_dtype=None, max_outer=1,
                                      gmres_m=2, method="newton_krylov")
    assert info["iterations"] == 1


# ── (c) a one-asset f64 ensemble solve through the kernels' plain versions ─

def test_f64_ensemble_through_the_kernel_route_matches_jax(ks):
    import jax.numpy as jnp
    from hank_tpu.parallel.ensemble import solve_ensemble_host as jsolve

    Z = ks.shocks["Z"][:2]
    x_ref, info_ref = jsolve(jnp.asarray(ks.x_ss), jnp.asarray(ks.J), {"Z": jnp.asarray(Z)},
                             ks.jm, ks.jss, ks.jss, eps=1e-10, method="newton_krylov",
                             direction_dtype=None, fused="xla")
    before, plain = kernel_calls(), PLAIN_F_CALLS[0]
    x, info = ens.solve_ensemble_host(to_torch(ks.x_ss), to_torch(ks.J), {"Z": to_torch(Z)},
                                      ks.tm, ks.tss, ks.tss, eps=1e-10, method="newton_krylov",
                                      direction_dtype=None, fused="pallas")
    got = counted_since(before)
    assert got["jvp_f64_batch"] > 0 and got["k2_batch"] > 0 and PLAIN_F_CALLS[0] == plain
    assert bool((info["residual_norm"] < 1e-10).all()) and info["stalled_paths"] == 0
    assert info["iterations"] == int(info_ref["iterations"])
    assert float(np.max(np.abs(x.numpy() - np.asarray(x_ref)))) <= 1e-9


# ── (d) the builds past each count ────────────────────────────────────────

def test_one_asset_batched_f64_map_tiers_and_the_error_past_them(ks, monkeypatch):
    """At n_e = 7, by the transcribed counts: the one-block kernel to n_a =
    529, the cluster one to 1660, the global-state one to 4980 (the single
    path's limits: a path axis adds nothing to a block); one past, the
    build raises naming fused='xla'. The same past every tier by a count one
    byte over."""
    from tests.test_torch_kernel_fit import BYTES, holds_clusters
    from tests.test_torch_common import build_small_ks_torch

    card = on_card(ks.tss)
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda which, n_a, n_e: BYTES[which](n_a, n_e))
    holds_clusters(monkeypatch)
    decided = {n_a: fs.sweep_kernel(cuda_build.JVP_F64_BATCH, n_a, 7)
               for n_a in (529, 530, 1660, 1661, 4980)}
    assert decided == {529: cuda_build.JVP_F64_BATCH, 530: cuda_build.CLUSTER_JVP_F64_BATCH,
                       1660: cuda_build.CLUSTER_JVP_F64_BATCH,
                       1661: cuda_build.GLOBAL_JVP_F64_BATCH,
                       4980: cuda_build.GLOBAL_JVP_F64_BATCH}
    fsb.make_fused_jvp_batch(build_small_ks_torch(T=ks.tm.compspec.T, n_a=4980, n_e=7), card,
                             card, f64)
    with pytest.raises(ValueError, match=r"the global-state batched f64 tangent sweep at grid "
                                         r"4981x7 needs .*fused='xla'"):
        fsb.make_fused_jvp_batch(build_small_ks_torch(T=ks.tm.compspec.T, n_a=4981, n_e=7),
                                 card, card, f64)
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: SMEM + 1)
    for dtype in (f64, torch.float32):
        with pytest.raises(ValueError, match="fused='xla'"):
            fsb.make_fused_jvp_batch(ks.tm, card, card, dtype)
    with pytest.raises(ValueError, match="fused='xla'"):
        fr.make_sweep_residual_fn_batch(ks.tm, card, card)


def test_two_asset_batched_f64_map_raises_past_the_counts(two, monkeypatch):
    """One byte past the f64 library's count, or past the forward push's
    4096 asset states, the batched tangent pair's build raises naming
    fused='xla'; at the count it records the shared-memory instantiations."""
    card = on_card(two.tss)
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", lambda *a, **k: SMEM)
    jvp = fs2.make_fused2_jvp_batch(two.tm, card, card, f64)
    assert (jvp.backward_kernel, jvp.forward_kernel) == (
        fs2.JVP_F64_BWD, fs2.FORWARD_KERNELS[fs2.F64_PUSH_JVP][0])
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", lambda *a, **k: SMEM + 1)
    with pytest.raises(ValueError, match="the f64 tangent pair at grid 24x12x4x2 needs .*"
                                         "fused='xla'"):
        fs2.make_fused2_jvp_batch(two.tm, card, card, f64)
    liquid = two.tm.heterogeneity["liquid"]
    wide = dataclasses.replace(two.tm, heterogeneity={
        **two.tm.heterogeneity, "liquid": dataclasses.replace(liquid, n=400)})
    with pytest.raises(ValueError, match="4800 asset states.*fused='xla'"):
        fs2.make_fused2_jvp_batch(wide, card, card, f64)


# ── on the card ───────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
@pytest.mark.parametrize("n_e", [5, 9])
def test_batched_f64_tangent_sweep_rows_are_single_launches(cuda, n_e):
    """Every row of each tier of the batched f64 tangent sweep (one block,
    cluster at every size, global state) bit for bit a single launch of the
    f64 tangent sweep, fallback counts included, at 40×n_e on seeded inputs
    and on the grid with two knots swapped; and the one-block kernel bit for
    bit the counting template's `<double, true, true>`."""
    from test_torch_sweep_bits import inputs, kernel_kwargs, same_bits, swapped_grid

    kw = kernel_kwargs()
    B = 3
    paths, c = inputs(B, f64, cuda, seed=3, n_e=n_e)
    for consts in (c, swapped_grid(c)):
        runs = [("one block", fsb.fused_sweep_jvp_f64_batch, {}),
                ("global state", fsb.fused_sweep_jvp_f64_batch_global, {})]
        runs += [(f"cluster of {C}", fsb.fused_sweep_jvp_f64_batch_cluster, {"cluster": C})
                 for C in range(1, min(n_e, 8) + 1)]
        singles, fb_single = [], torch.zeros((B, 2), dtype=torch.int32, device=cuda)
        for b in range(B):
            singles.append(fs.fused_sweep_jvp_f64(*(q[b].contiguous() for q in paths), *consts,
                                                  fallback_rows=fb_single[b], **kw))
        for name, fn, extra in runs:
            fb = torch.zeros((B, 2), dtype=torch.int32, device=cuda)
            out = fn(*paths, *consts, fallback_rows=fb, **kw, **extra)
            for b in range(B):
                assert all(same_bits(o[b], s) for o, s in zip(out, singles[b])), (name, b)
            assert torch.equal(fb, fb_single), name
        previous = fsb.fused_sweep_jvp_f64_batch_previous(*paths, *consts, **kw)
        out = fsb.fused_sweep_jvp_f64_batch(*paths, *consts, **kw)
        assert all(same_bits(o, p) for o, p in zip(out, previous))
    assert int(fb_single[:, 1].sum()) > 0                  # the swapped grid's fallback


@pytest.mark.gpu
def test_batched_f64_tangent_pair_rows_are_single_launches(cuda):
    """Every row of the batched tangent pair (both backward instantiations,
    both forward ones, on the cluster sizes the rule and one other take)
    bit for bit a single launch of the single-path pair, at B = 3 with a NaN
    in one row."""
    from test_torch_fused2_batch import same_bits, seeded_inputs

    tm, prices, tangents, VT, D0 = seeded_inputs(cuda)
    paths = [q.contiguous() for q in (*prices, *tangents)]
    singles = []
    for b in range(3):
        sp, sd = fs2.fused2_policies_jvp_f64(*(q[b].contiguous() for q in paths), VT, tm)
        singles.append((sp, sd, *fs2.fused2_forward_jvp_f64(sp, sd, D0, tm)))
    grid = fs2._state(tm)[:3]
    for bwd in (fs2.JVP_F64_BWD, fs2.JVP_F64_BWD_GLOBAL):
        for C in sorted({fs2.batch_cluster_of("household_sweep2_f64", bwd, 3, grid), 2}):
            pol, dpol = fs2._launch_bwd_jvp_f64(paths, VT, tm, bwd, 3, C)
            for b in range(3):
                for k in KEYS:
                    assert same_bits(pol[k][b], singles[b][0][k]), (bwd, C, b, k)
                    assert same_bits(dpol[k][b], singles[b][1][k]), (bwd, C, b, k)
    tensors = [d[k] for d in (pol, dpol) for k in KEYS]
    for fwd in fs2.FORWARD_KERNELS[fs2.F64_PUSH_JVP]:
        for C in sorted({fs2.batch_cluster_of("household_sweep2_f64", fwd, 3, grid), 3}):
            aggs, daggs = fs2._launch_fwd_jvp_f64_batch(tensors, 3, tm.compspec.T - 1, D0, tm,
                                                        fwd, C)
            for b in range(3):
                for k in KEYS:
                    assert same_bits(aggs[k][b], singles[b][2][k]), (fwd, C, b, k)
                    assert same_bits(daggs[k][b], singles[b][3][k]), (fwd, C, b, k)
    launches = (fs2.fused2_policies_jvp_f64_batch.launches,
                fs2.fused2_forward_jvp_f64_batch.launches)
    pol, dpol = fs2.fused2_policies_jvp_f64_batch(*paths, VT, tm)
    aggs, _ = fs2.fused2_forward_jvp_f64_batch(pol, dpol, D0, tm)
    assert (fs2.fused2_policies_jvp_f64_batch.launches,
            fs2.fused2_forward_jvp_f64_batch.launches) == (launches[0] + 1, launches[1] + 1)
    for b in range(3):
        finite = all(bool(torch.isfinite(aggs[k][b]).all()) for k in KEYS)
        assert finite == (b != 1), b                      # NaN in row 1 only
