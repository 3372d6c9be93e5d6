"""PyTorch port: two-asset shock ensembles through the path-batched kernels.

On the card a two-asset ensemble takes the batched kernels 5-6 for its f32
directions (`ops/fused_sweep2.make_fused2_jvp_batch`) and the batched f64
residual pair for F_b (`ops/fused_residual2.make_fused2_residual_fn_f64_batch`);
on CPU tensors their wrappers run their plain versions (loops over rows of
the single-path plain versions). On the small two-asset model (24×12×4×2,
T=12; `tests/test_torch_fused2_f64.py`'s `Case`: the JAX package's steady
state carried across), with inputs from a numpy seed, this file holds:
  (a) the batched direction map's rows against `jax.jvp` of the JAX
      package's f32 pipeline per row, at 5e-5·max(scale, 1) (the bound of
      `tests/test_torch_fused2.py`), with its hat lowerings pinned;
  (b) F_b against the JAX package's `residual_ensemble` on 3 rows with
      distinct G, within 1e-12·max(scale, 1);
  (c) the routes: CPU tensors take the plain route, a state that reports
      itself on the card (`OnCard`) the batched route's plain versions and
      no plain f64 F, and the fit check raises ValueError when a route is
      built for a grid past the library's count (monkeypatched);
  (d) `solve_ensemble_host(method="newton_krylov")` at B=2 on the batched
      route's plain versions against the JAX package's
      `solve_ensemble_host(direction_dtype=f32, fused="xla")`: every row ≤
      eps, roots within 1e-9 (the outers are printed: the f32 tail may
      change them);
and the cluster-size rule and the path block the batched forward kernels
read. The kernels themselves run only on a card (`gpu` marker): there every
row of each batched kernel is held bit for bit to a single launch, at B=3 on
seeded inputs with a NaN in one row. JAX is imported inside the CPU tests
only, and nothing of `tests/` in the card tests, so they run without
either: `python -m pytest --noconftest -m gpu tests/test_torch_fused2_batch.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hank_tpu_torch.parallel.ensemble as ens
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_residual2 as fr2
from hank_tpu_torch.ops import fused_sweep2 as fs2

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64
KEYS = ("B", "A", "C")
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)


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


@pytest.fixture(scope="module")
def case():
    from tests.test_torch_fused2_f64 import Case

    return Case()


def shocks(case, s, rho) -> np.ndarray:
    """(B, T-1) fiscal shocks G_b,t = s_b·ρ_bᵗ."""
    t = np.arange(1, case.tm.compspec.T, dtype=np.float64)
    return np.asarray(s)[:, None] * np.asarray(rho)[:, None] ** t[None, :]


def noisy_rows(case, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return case.x_ss[None] * (1.0 + 0.002 * rng.normal(size=(B, case.x_ss.shape[0])))


def count_on(monkeypatch, nbytes):
    """Both libraries' shared-memory counts replaced by `nbytes`; returns the
    list of (library, which, cluster) asked."""
    asked = []

    def counter(name):
        def counted(which, n_b, n_a, n_e, cluster=1):
            asked.append((name, which, cluster))
            return nbytes
        return counted

    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", counter("f32"))
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", counter("f64"))
    return asked


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


def batch_counts():
    """(plain versions' calls, kernel launches) of the four batched wrappers."""
    return ((fs2.fused2_policies_jvp_batch_reference.calls,
             fs2.fused2_forward_jvp_batch_reference.calls,
             fr2.fused2_policies_f64_batch_reference.calls,
             fr2.fused2_forward_f64_batch_reference.calls),
            (fs2.fused2_policies_jvp_batch.launches, fs2.fused2_forward_jvp_batch.launches,
             fr2.fused2_policies_f64_batch.launches, fr2.fused2_forward_f64_batch.launches))


def bounded(out, ref, bound=5e-5) -> bool:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    scale = float(np.max(np.abs(ref)))
    return float(np.max(np.abs(out - ref))) <= bound * max(scale, 1.0)


# ── (a) the batched direction map ─────────────────────────────────────────

def test_batched_direction_rows_match_jax_jvp_of_the_f32_pipeline(case, monkeypatch):
    """Each row of `make_fused2_jvp_batch` (price JVPs, the batched kernels'
    plain versions, the f32 tail) against `jax.jvp` of the JAX package's f32
    equilibrium map under that row's shock."""
    import jax
    import jax.numpy as jnp
    from hank_tpu.ops.precision import cast_model, cast_paths, cast_ss
    from hank_tpu.solvers.newton import make_full_residual_fn

    monkeypatch.setenv("HANK_TPU_BILINEAR", "hat")
    monkeypatch.setenv("HANK_TPU_INTERP", "hat")
    G = shocks(case, [0.005, 0.01], [0.5, 0.8])
    x_b = noisy_rows(case, 2, 7)
    v_b = np.random.default_rng(8).normal(size=x_b.shape)
    before = batch_counts()
    out = fs2.make_fused2_jvp_batch(case.tm, case.tss, case.tss)(
        to_torch(x_b), to_torch(v_b), {"G": to_torch(G)})
    calls, launches = batch_counts()
    assert [a - b for a, b in zip(calls, before[0])] == [1, 1, 0, 0]
    assert launches == before[1]
    assert out.dtype == f32 and out.shape == x_b.shape
    m32, s32 = cast_model(case.jm, jnp.float32), cast_ss(case.jss, jnp.float32)
    for b in range(2):
        F32 = make_full_residual_fn(m32, s32, s32, cast_paths({"G": jnp.asarray(G[b])},
                                                              jnp.float32))
        _, ref = jax.jvp(F32, (jnp.asarray(x_b[b], jnp.float32),),
                         (jnp.asarray(v_b[b], jnp.float32),))
        assert bounded(out[b], ref), b


def test_batched_plain_versions_are_the_single_path_ones(case):
    """On CPU tensors each batched wrapper's rows are the single-path
    wrapper's on that row, bit for bit (the plain versions), in the batched
    layout; the wrappers check their inputs."""
    tm, tss = case.tm, case.tss
    m32 = fs2.cast_model(tm, f32)
    Tm1 = tm.compspec.T - 1
    rng = np.random.default_rng(3)
    x_b = noisy_rows(case, 2, 4)
    hook = fs2._fused2_price_hook(tm)
    prices = [torch.stack(q) for q in zip(*(hook(to_torch(x).reshape(Tm1, -1), case.exog, tm)
                                            for x in x_b))]
    p32 = [q.to(f32).contiguous() for q in prices]
    d32 = [to_torch(1e-3 * rng.normal(size=(2, Tm1)), f32) for _ in range(4)]
    VT = tss.value.to(f32)
    pol, dpol = fs2.fused2_policies_jvp_batch(*p32, *d32, VT, m32)
    aggs, daggs = fs2.fused2_forward_jvp_batch(pol, dpol, tss.D.to(f32), m32)
    p64 = [q.contiguous() for q in prices]
    pol64 = fr2.fused2_policies_f64_batch(*p64, tss.value, tm)
    aggs64 = fr2.fused2_forward_f64_batch(pol64, tss.D, tm)
    for b in range(2):
        sp, sd = fs2.fused2_policies_jvp(*(q[b] for q in (*p32, *d32)), VT, m32)
        sa, sda = fs2.fused2_forward_jvp(sp, sd, tss.D.to(f32), m32)
        s64 = fr2.fused2_policies_f64(*(q[b] for q in p64), tss.value, tm)
        sa64 = fr2.fused2_forward_f64(s64, tss.D, tm)
        for k in KEYS:
            assert pol[k].shape == (2, Tm1, 24, 12, 4, 2) and aggs[k].shape == (2, Tm1)
            assert torch.equal(pol[k][b], sp[k]) and torch.equal(dpol[k][b], sd[k])
            assert torch.equal(aggs[k][b], sa[k]) and torch.equal(daggs[k][b], sda[k])
            assert torch.equal(pol64[k][b], s64[k]) and torch.equal(aggs64[k][b], sa64[k])
    with pytest.raises(ValueError, match=r"\(B, T-1\) paths"):
        fs2.fused2_policies_jvp_batch(*(q[0] for q in p32), *(q[0] for q in d32), VT, m32)
    with pytest.raises(TypeError, match="expected torch.float64"):
        fr2.fused2_policies_f64_batch(*p32, VT, tm)
    with pytest.raises(ValueError, match="D0"):
        fs2.fused2_forward_jvp_batch(pol, dpol, tss.D.to(f32)[:-1], m32)
    with pytest.raises(TypeError, match="expected torch.float64"):
        fr2.fused2_forward_f64_batch(pol, tss.D, tm)


# ── (b) F_b ────────────────────────────────────────────────────────────────

def test_batched_residual_matches_jax_residual_ensemble(case):
    from hank_tpu.parallel.ensemble import residual_ensemble as jres
    import jax.numpy as jnp

    G = shocks(case, [0.005, 0.0075, 0.01], [0.5, 0.65, 0.8])
    x_b = noisy_rows(case, 3, 5)
    ref = np.asarray(jres(jnp.asarray(x_b), {"G": jnp.asarray(G)}, case.jm, case.jss,
                          case.jss))
    before = batch_counts()
    out = fr2.make_fused2_residual_fn_f64_batch(case.tm, case.tss, case.tss)(
        to_torch(x_b), {"G": to_torch(G)})
    calls, _ = batch_counts()
    assert [a - b for a, b in zip(calls, before[0])] == [0, 0, 1, 1]
    assert out.dtype == f64 and out.shape == ref.shape == x_b.shape
    scale = float(np.max(np.abs(ref)))
    assert scale > 1e-4                      # rows off the root
    assert float(np.max(np.abs(out.numpy() - ref))) <= 1e-12 * max(scale, 1.0)


# ── (c) routes and the fit check ──────────────────────────────────────────

@pytest.mark.parametrize("where", ["cpu", "card"])
def test_residual_ensemble_routes(case, monkeypatch, where):
    """CPU tensors: the vmapped plain F, the batched wrappers untouched. A
    state on the card: the batched pair (here its plain versions), asked
    its fit on the default clusters, and no plain F. Both give JAX's F_b
    within 1e-12 of each other."""
    G = shocks(case, [0.005, 0.01], [0.5, 0.8])
    x_b = to_torch(noisy_rows(case, 2, 6))
    ss = case.tss if where == "cpu" else on_card(case.tss)
    asked = count_on(monkeypatch, SMEM)
    before, plain = batch_counts(), PLAIN_F_CALLS[0]
    out = ens.residual_ensemble(x_b, {"G": to_torch(G)}, case.tm, case.tss, ss)
    calls, launches = batch_counts()
    n_e = case.tm.heterogeneity["income"].n
    if where == "cpu":
        assert (calls, launches) == before and not asked
        assert PLAIN_F_CALLS[0] > plain
    else:
        assert [a - b for a, b in zip(calls, before[0])] == [0, 0, 1, 1]
        assert launches == before[1] and PLAIN_F_CALLS[0] == plain
        assert sorted(asked) == [("f64", 0, fs2.default_bwd_cluster(n_e)),
                                 ("f64", 1, fs2.default_cluster(n_e))]
    other = fr2.make_fused2_residual_fn_f64_batch(case.tm, case.tss, case.tss)(
        x_b, {"G": to_torch(G)})
    assert float((out - other).abs().max()) <= 1e-12


def test_solve_ensemble_host_on_cpu_tensors_keeps_the_plain_route(case):
    """CPU tensors: the mixed-tail map and the plain F, as before; the
    batched wrappers are not called (one outer, cut for time)."""
    G = shocks(case, [0.005, 0.01], [0.5, 0.8])
    before, plain = batch_counts(), PLAIN_F_CALLS[0]
    ens.solve_ensemble_host(to_torch(case.x_ss), case.J, {"G": to_torch(G)}, case.tm,
                            case.tss, case.tss, eps=1e-10, method="newton_krylov",
                            max_outer=1)
    assert batch_counts() == before and PLAIN_F_CALLS[0] > plain


def test_f64_directions_on_the_card_keep_vmapped_ad(case, monkeypatch):
    """With f64 directions a state on the card takes the batched f64 pair
    for F_b and the batched f64 tangent pair for the directions
    (`fused2_*_jvp_f64_batch`, their plain versions here); vmapped AD
    through the plain F, which the name recalls, is left to
    `fused="xla"`. The batched kernels 5-6 are not called (one short
    outer, cut for time)."""
    count_on(monkeypatch, SMEM)
    card = on_card(case.tss)
    G = shocks(case, [0.005, 0.01], [0.5, 0.8])
    before, plain = batch_counts(), PLAIN_F_CALLS[0]
    pair = (fs2.fused2_policies_jvp_f64_batch_reference.calls,
            fs2.fused2_forward_jvp_f64_batch_reference.calls)
    ens.solve_ensemble_host(to_torch(case.x_ss), case.J, {"G": to_torch(G)}, case.tm, card,
                            card, eps=1e-10, method="newton_krylov", direction_dtype=None,
                            max_outer=1, gmres_m=2)
    calls, launches = batch_counts()
    got = [a - b for a, b in zip(calls, before[0])]
    assert got[:2] == [0, 0] and got[2] > 0 and got[3] > 0
    assert launches == before[1] and PLAIN_F_CALLS[0] == plain
    assert (fs2.fused2_policies_jvp_f64_batch_reference.calls > pair[0]
            and fs2.fused2_forward_jvp_f64_batch_reference.calls > pair[1])


def test_the_fit_check_raises_when_a_route_is_built(case, monkeypatch):
    """One byte past the library's count stops every two-asset route on the
    card when it is built, before a sweep, naming the plain routes."""
    card = on_card(case.tss)
    G = {"G": to_torch(shocks(case, [0.005, 0.01], [0.5, 0.8]))}
    x0 = to_torch(case.x_ss)
    builds = {
        "f32 direction map": (lambda: fs2.make_fused2_jvp_batch(case.tm, card, card),
                              "kernels 5-6 at grid 24x12x4x2"),
        "f64 F_b": (lambda: fr2.make_fused2_residual_fn_f64_batch(case.tm, card, card),
                    "f64 residual pair at grid 24x12x4x2"),
        "residual_ensemble": (lambda: ens.residual_ensemble(x0[None].expand(2, -1), G, case.tm,
                                                            card, card),
                              "f64 residual pair"),
        "solve_ensemble_host": (lambda: ens.solve_ensemble_host(
            x0, case.J, G, case.tm, card, card, method="newton_krylov"), "needs"),
    }
    count_on(monkeypatch, SMEM + 1)
    before = batch_counts()
    for name, (build, match) in builds.items():
        with pytest.raises(ValueError, match=match):
            build()
    assert batch_counts() == before


# ── (d) a lockstep Newton-Krylov solve ────────────────────────────────────

def test_newton_krylov_ensemble_matches_jax(case, monkeypatch):
    """B=2 fiscal shocks (s = 0.005, 0.01; ρ = 0.5, 0.8) from x_ss through the
    batched route's plain versions, against the JAX package's vmapped XLA
    route with f32 directions."""
    import jax.numpy as jnp
    from hank_tpu.parallel.ensemble import solve_ensemble_host as jsolve

    eps = 1e-10
    G = shocks(case, [0.005, 0.01], [0.5, 0.8])
    J = case.J.numpy()
    x_ref, info_ref = jsolve(jnp.asarray(case.x_ss), jnp.asarray(J), {"G": jnp.asarray(G)},
                             case.jm, case.jss, case.jss, eps=eps, method="newton_krylov",
                             direction_dtype=jnp.float32, fused="xla")
    count_on(monkeypatch, SMEM)
    card = on_card(case.tss)
    before, plain = batch_counts(), PLAIN_F_CALLS[0]
    x, info = ens.solve_ensemble_host(to_torch(case.x_ss), case.J, {"G": to_torch(G)},
                                      case.tm, card, card, eps=eps, method="newton_krylov")
    calls, launches = batch_counts()
    print(f"outers: port {info['iterations']}, JAX {int(info_ref['iterations'])}; "
          f"matvecs: port {info['inner_iterations']}, JAX {int(info_ref['inner_iterations'])}")
    assert all(a > b for a, b in zip(calls, before[0])) and launches == before[1]
    assert PLAIN_F_CALLS[0] == plain
    assert bool((info["residual_norm"] <= eps).all()) and info["stalled_paths"] == 0
    assert bool((np.asarray(info_ref["residual_norm"]) <= eps).all())
    assert float(np.max(np.abs(x.numpy() - np.asarray(x_ref)))) <= 1e-9


# ── the cluster-size rule and the path block ───────────────────────────────

@pytest.mark.parametrize("B,clusters,expect", [
    (1, {10: 8, 5: 26, 2: 66, 1: 132}, 10),       # one path: the default
    (8, {10: 8, 5: 26, 2: 66, 1: 132}, 10),       # one wave at the default
    (16, {10: 8, 5: 26, 2: 66, 1: 132}, 10),      # 2 waves x 1 = 1 wave x 2: the larger
    (24, {10: 8, 5: 26, 2: 66, 1: 132}, 5),       # 3 x 1 against 1 x 2
    (64, {10: 8, 5: 26, 2: 66, 1: 132}, 2),       # 8, 3 x 2 = 6, 1 x 5, 1 x 10
    (64, {10: 0, 5: 26, 2: 66, 1: 132}, 2),       # a size the card cannot hold is skipped
])
def test_batch_cluster_takes_the_fewest_waves_times_units(B, clusters, expect):
    units, default = 10, 10
    got = fs2.batch_cluster(B, units, default, lambda C: C in clusters,
                            lambda C: clusters.get(C, 0))
    assert got == expect


def test_batch_cluster_skips_sizes_past_a_block():
    # Only the default fits a block: it is taken whatever the waves.
    assert fs2.batch_cluster(64, 10, 10, lambda C: C == 10, lambda C: 8) == 10


@pytest.mark.parametrize("library,which,expect", [
    ("household_sweep2", 3, 3), ("household_sweep2", 2, 7), ("household_sweep2", 4, 7),
    ("household_sweep2_f64", 0, 3), ("household_sweep2_f64", 1, 7),
    ("household_sweep2_f64", 2, 7)])
def test_batch_cluster_of_each_kernel(monkeypatch, library, which, expect):
    """Each batched kernel's units and default (the backward kernels 4 income
    states on up to 4 blocks, the forward kernels 8 groups on up to 8 at
    n_e = 4), asked of its own library: with one cluster of the default in
    flight and 100 of any smaller size, B = 4 takes one wave at two units a
    block, the largest such size."""
    asked = []

    def clusters(lib, w, n_b, n_a, n_e, C):
        asked.append((lib, w))
        return 1 if C == (4 if expect == 3 else 8) else 100

    monkeypatch.setattr(cuda_build, "max_clusters", clusters)
    counted = count_on(monkeypatch, SMEM)
    assert fs2.batch_cluster_of(library, which, 4, (24, 12, 4)) == expect
    assert set(asked) == {(library, which)}
    assert {(lib, w) for lib, w, _ in counted} == {("f32" if library == "household_sweep2"
                                                    else "f64", which)}


def test_path_block_reads_the_batched_layout_in_place():
    full = torch.arange(2 * 6 * 3 * 5, dtype=f32).reshape(2, 6, 3, 5)
    views = [full[:, q] for q in range(6)]
    block = fs2.path_block(views)
    assert block.data_ptr() == full.data_ptr() and torch.equal(block, full)
    other = [v.clone() for v in views]                  # separate tensors: stacked
    stacked = fs2.path_block(other)
    assert stacked.data_ptr() != full.data_ptr() and torch.equal(stacked, full)
    assert torch.equal(fs2.path_block(views[::-1]), torch.stack(views[::-1], 1))


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


def small_two_asset_on(dev):
    """`tests/torch_ranks.py::build_small_two_asset_torch` on `dev`, built
    here so that the card tests import nothing of `tests/`."""
    from hank_tpu_torch.model.grids import make_double_exponential_grid, rouwenhorst
    from hank_tpu_torch.model.structures import HeterogeneityDimension as H
    from hank_tpu_torch.models import load_model
    from hank_tpu_torch.models.hank_two_asset import access_process

    def t(a):
        return torch.tensor(a, dtype=f64, device=dev)

    Pi, _, z = rouwenhorst(4, 0.966, 0.283)
    g, P = access_process(2, 0.10)
    model = load_model("hank_two_asset", T=12, device=dev)
    return dataclasses.replace(model, heterogeneity={
        "liquid": H("liquid", "endogenous", 24, t(make_double_exponential_grid(0.0, 120.0, 24)),
                    None, "B"),
        "illiquid": H("illiquid", "endogenous", 12,
                      t(make_double_exponential_grid(0.0, 200.0, 12)), None, "A"),
        "income": H("income", "exogenous", 4, t(z), t(Pi), None),
        "access": H("access", "exogenous", 2, t(g), t(P), None)})


def test_small_model_is_the_shared_one():
    from tests.torch_ranks import build_small_two_asset_torch

    a, b = small_two_asset_on("cpu"), build_small_two_asset_torch()
    assert a.heterogeneity.keys() == b.heterogeneity.keys()
    for k, d in a.heterogeneity.items():
        e = b.heterogeneity[k]
        assert (d.n, d.dim_type, d.policy_var) == (e.n, e.dim_type, e.policy_var)
        assert torch.equal(d.grid, e.grid)
        assert (d.transition is None) == (e.transition is None)
        assert d.transition is None or torch.equal(d.transition, e.transition)


def seeded_inputs(dev, B: int = 3, nan_row: int = 1):
    """The small two-asset model on the card and seeded (B, T-1) prices,
    tangents, V_T and D0; row `nan_row` of r holds one NaN."""
    tm = small_two_asset_on(dev)
    Tm1 = tm.compspec.T - 1
    n_b, n_a, n_e = 24, 12, 4
    rng = np.random.default_rng(21)
    level = np.array([0.01, 0.015, 0.8, 0.3])[:, None, None]
    prices = level * (1.0 + 0.05 * rng.random((4, B, Tm1)))
    prices[0, nan_row, Tm1 // 2] = np.nan
    tangents = 1e-3 * rng.normal(size=(4, B, Tm1))
    VT = 0.05 + 2.0 * rng.random((2, n_b, n_a, n_e, 2))
    D0 = rng.random((n_b, n_a, n_e, 2))
    D0 /= D0.sum()
    return (tm, [to_torch(q).to(dev) for q in prices], [to_torch(q).to(dev) for q in tangents],
            to_torch(VT).to(dev), to_torch(D0).to(dev))


def same_bits(a, b) -> bool:
    view = torch.int64 if a.dtype == f64 else torch.int32
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


@pytest.mark.gpu
def test_batched_kernels_5_6_rows_are_single_launches(cuda):
    tm, prices, tangents, VT, D0 = seeded_inputs(cuda)
    m32 = fs2.cast_model(tm, f32)
    p32 = [q.to(f32).contiguous() for q in (*prices, *tangents)]
    VT32, D32 = VT.to(f32).contiguous(), D0.to(f32).contiguous()
    launches = fs2.fused2_policies_jvp_batch.launches, fs2.fused2_forward_jvp_batch.launches
    pol, dpol = fs2.fused2_policies_jvp_batch(*p32, VT32, m32)
    aggs, daggs = fs2.fused2_forward_jvp_batch(pol, dpol, D32, m32)
    assert (fs2.fused2_policies_jvp_batch.launches,
            fs2.fused2_forward_jvp_batch.launches) == (launches[0] + 1, launches[1] + 1)
    for b in range(3):
        sp, sd = fs2.fused2_policies_jvp(*(q[b].contiguous() for q in p32), VT32, m32)
        sa, sda = fs2.fused2_forward_jvp(sp, sd, D32, m32)
        for k in KEYS:
            assert same_bits(pol[k][b], sp[k]) and same_bits(dpol[k][b], sd[k]), (b, k)
            assert same_bits(aggs[k][b], sa[k]) and same_bits(daggs[k][b], sda[k]), (b, k)
        finite = all(bool(torch.isfinite(aggs[k][b]).all()) for k in KEYS)
        assert finite == (b != 1), b                     # NaN in row 1 only


@pytest.mark.gpu
def test_batched_f64_pair_rows_are_single_launches(cuda):
    tm, prices, _, VT, D0 = seeded_inputs(cuda)
    p64 = [q.contiguous() for q in prices]
    pol = fr2.fused2_policies_f64_batch(*p64, VT, tm)
    aggs = fr2.fused2_forward_f64_batch(pol, D0, tm)
    for b in range(3):
        sp = fr2.fused2_policies_f64(*(q[b].contiguous() for q in p64), VT, tm)
        sa = fr2.fused2_forward_f64(sp, D0, tm)
        for k in KEYS:
            assert same_bits(pol[k][b], sp[k]) and same_bits(aggs[k][b], sa[k]), (b, k)
        finite = all(bool(torch.isfinite(aggs[k][b]).all()) for k in KEYS)
        assert finite == (b != 1), b
