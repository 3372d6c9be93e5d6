"""PyTorch port: the two-asset full-precision residual through the f64 kernel pair.

`ops/fused_residual2.py` computes the two-asset F(x) through an FP64
values-only kernel pair (`csrc/household_sweep2_f64.cu`); on CPU tensors its
wrappers run their plain versions (the backward scan through the ported
`ValueFunction` and `forward_iteration`, in f64). On the small two-asset
model (24×12×4×2, T=12; the JAX package's `build_small_two_asset` and its
cached steady state), with inputs from a numpy seed, this file holds:
  - the pair's F against the JAX package's f64 `make_full_residual_fn`, at
    x_ss and at x_ss with seeded noise, within TOL (the bound the port's
    plain two-asset blocks meet against JAX in `tests/test_torch_two_asset.py`:
    1e-12 of the output's scale);
  - `residual_route`'s choices per `residual_mode`;
  - the fit decision on the card (the library's count monkeypatched, the
    steady state made to report itself on the card), and no count asked on
    CPU tensors;
  - the boehl two-phase and Newton-Krylov solves with `residual_mode="ds"`
    (the pair) against `"f64"` (the plain pipeline): the same outers,
    matvecs and F calls, so the f32-residual phase stays on for this family.
The kernels themselves run only on a card (`gpu` marker): there the pair is
held to its plain version and two launches to each other.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_residual2 as fr2
from hank_tpu_torch.ops import fused_sweep2 as fs2
from hank_tpu_torch.solvers.linear import linear_impulse_response
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_common import build_small_two_asset_torch, ss_to_numpy, to_torch
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64
KEYS = ("B", "A", "C")
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
# The pair's F against the JAX package's f64 F: both run the same f64
# arithmetic and differ in the order of a few sums (the expectation, the
# lottery's einsum, the aggregates), ~1e-16 relative through T-1 periods.
TOL = 1e-12


class Case:
    """The small two-asset model in both packages, its steady state, the
    fiscal shock, x_ss and J̄."""

    def __init__(self):
        from hank_tpu.models.hank_two_asset import fiscalShock
        from hank_tpu.solvers.ss_jacobian import get_steady_state_jacobian as jjac
        from tests.conftest import solve_ss_cached
        from tests.test_hank_two_asset import build_small_two_asset

        self.jm = build_small_two_asset()
        self.jss = solve_ss_cached(self.jm)
        self.tm = build_small_two_asset_torch()
        self.tss = steady_state_from_numpy(ss_to_numpy(self.jss), device="cpu")
        self.G = np.asarray(fiscalShock(self.jm.compspec.T - 1))
        self.exog = {"G": to_torch(self.G)}
        self.x_ss = x_ss_of(self.jm, self.jss)
        self.J = to_torch(np.asarray(jjac(self.jss, self.jm)))

    def point(self, name: str) -> np.ndarray:
        if name == "x_ss":
            return self.x_ss
        rng = np.random.default_rng(5)
        return self.x_ss * (1.0 + 0.002 * rng.normal(size=self.x_ss.shape))


@pytest.fixture(scope="module")
def case():
    return Case()


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), as the
    route and the pair's build ask; the wrappers look at `device` and run
    their plain versions."""

    @property
    def is_cuda(self):
        return True


def on_card(ss):
    return dataclasses.replace(ss, value=ss.value.as_subclass(OnCard))


PLAIN_F_CALLS = [0]


@pytest.fixture(autouse=True)
def count_plain_residual(monkeypatch):
    """Count the plain f64 F's evaluations by the routes and solvers built
    in a test (they take it by `newton_mod.make_full_residual_fn`)."""
    plain = newton_mod.make_full_residual_fn

    def counted_residual(*a):
        F = plain(*a)

        def counted(x):
            PLAIN_F_CALLS[0] += 1
            return F(x)

        return counted

    monkeypatch.setattr(newton_mod, "make_full_residual_fn", counted_residual)


def counts():
    return (fr2.fused2_policies_f64_reference.calls, fr2.fused2_forward_f64_reference.calls,
            fr2.fused2_policies_f64.launches, fr2.fused2_forward_f64.launches,
            PLAIN_F_CALLS[0])


@pytest.mark.parametrize("where", ["x_ss", "noisy"])
def test_pair_matches_jax_full_residual(case, where):
    from hank_tpu.solvers.newton import make_full_residual_fn as jax_full

    x = case.point(where)
    ref = np.asarray(jax_full(case.jm, case.jss, case.jss, {"G": jnp.asarray(case.G)})(
        jnp.asarray(x)))
    before = counts()
    F = fr2.make_fused2_residual_fn_f64(case.tm, case.tss, case.tss, case.exog)(to_torch(x))
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0, 0, 0]
    assert F.dtype == f64 and F.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert float(np.max(np.abs(F.numpy() - ref))) <= TOL * max(scale, 1.0)
    if where == "noisy":
        assert scale > 1e-4                  # a point off the root


def test_plain_versions_are_the_blocks(case):
    """The pair's plain versions are the backward scan and
    `forward_iteration` in f64: their policies and aggregates equal the
    plain blocks' bit for bit, and the wrappers check their inputs."""
    from hank_tpu_torch.blocks.backward import backward_iteration
    from hank_tpu_torch.blocks.forward import forward_iteration

    tm, tss = case.tm, case.tss
    x = to_torch(case.point("noisy"))
    Tm1 = tm.compspec.T - 1
    prices = [q.contiguous() for q in
              fs2._fused2_price_hook(tm)(x.reshape(Tm1, -1), case.exog, tm)]
    pol = fr2.fused2_policies_f64(*prices, tss.value, tm)
    ref = backward_iteration(x, case.exog, tm, tss.vars, tss.value)
    assert all(torch.equal(pol[k], ref[k]) for k in KEYS)
    aggs = fr2.fused2_forward_f64(pol, tss.D, tm)
    assert all(torch.equal(a, b) for a, b in
               zip((aggs[k] for k in KEYS), (forward_iteration(ref, tm, tss.D)[k]
                                             for k in KEYS)))
    with pytest.raises(TypeError, match="expected torch.float64"):
        fr2.fused2_policies_f64(*(p.float() for p in prices), tss.value.float(), tm)
    with pytest.raises(ValueError, match="value_T"):
        fr2.fused2_policies_f64(*prices, tss.value[:, :-1].contiguous(), tm)
    with pytest.raises(ValueError, match="D0"):
        fr2.fused2_forward_f64(pol, tss.D[:-1], tm)


@pytest.mark.parametrize("mode,pair", [("auto", False), ("ds", True), ("f64", False)])
def test_residual_route_on_cpu_tensors(case, mode, pair):
    """On CPU tensors "auto" keeps the plain f64 pipeline (as the reference
    does everywhere for this family), "ds" takes the pair's plain
    versions, "f64" the plain pipeline; all give the same F."""
    x = to_torch(case.point("noisy"))
    before = counts()
    F = newton_mod.residual_route(case.tm, case.tss, case.tss, case.exog, mode)(x)
    got = [a - b for a, b in zip(counts(), before)]
    assert got == ([1, 1, 0, 0, 0] if pair else [0, 0, 0, 0, 1])
    plain = newton_mod.make_full_residual_fn(case.tm, case.tss, case.tss, case.exog)(x)
    assert torch.equal(F, plain)


def test_linear_start_takes_the_routes_residual(case, monkeypatch):
    """`linear_impulse_response` evaluates F(x_ss) by the route's residual:
    on CPU tensors the plain f64 F, on the card the f64 pair (here its plain
    versions, the count patched), never the plain F there; both warm starts
    agree to 1e-12."""
    before = counts()
    x_cpu, info_cpu = linear_impulse_response(case.J, case.exog, case.tm, case.tss, case.tss,
                                              compute_residual=False)
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 0, 0, 1]
    count_on(monkeypatch, SMEM)
    card = on_card(case.tss)
    before = counts()
    x_card, info_card = linear_impulse_response(case.J, case.exog, case.tm, card, card,
                                                compute_residual=False)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0, 0, 0]
    assert float((x_card - x_cpu).abs().max()) <= 1e-12
    assert abs(info_card["f0_norm"] - info_cpu["f0_norm"]) <= 1e-12


def test_residual_mode_ds_raises_outside_both_families(case):
    other = dataclasses.replace(case.tm, value_fn=lambda v, x, m: None)
    assert not fs2.supports_fused_sweep2(other)
    with pytest.raises(ValueError, match="residual_mode='ds' needs a residual kernel"):
        newton_mod.residual_route(other, case.tss, case.tss, case.exog, "ds")
    with pytest.raises(ValueError, match="fused2_prices"):
        fr2.make_fused2_residual_fn_f64(other, case.tss, case.tss, case.exog)


def count_on(monkeypatch, nbytes):
    """The library's count of the pair replaced by `nbytes`; returns the
    list of (which, cluster) asked."""
    asked = []

    def counted(which, n_b, n_a, n_e, cluster=1):
        asked.append((which, cluster))
        return nbytes

    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", counted)
    return asked


def test_auto_on_the_card_takes_the_pair_or_raises_at_the_build(case, monkeypatch):
    """On the card "auto" builds the pair where both kernels fit a block
    (asking each on its default cluster), and one byte past the count
    raises ValueError when the residual or the solver is built, naming
    the plain route; "f64" builds without asking."""
    tm, card = case.tm, on_card(case.tss)
    n_e = tm.heterogeneity["income"].n
    x = to_torch(case.x_ss)
    asked = count_on(monkeypatch, SMEM)
    before = counts()
    newton_mod.residual_route(tm, card, card, case.exog, "auto")(x)
    assert sorted(asked) == [(0, fs2.default_bwd_cluster(n_e)), (1, fs2.default_cluster(n_e))]
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0, 0, 0]
    count_on(monkeypatch, SMEM + 1)
    match = f"f64 residual pair at grid 24x12x{n_e}x2 needs {SMEM + 1} bytes.*residual_mode='f64'"
    for build in (lambda: fr2.make_fused2_residual_fn_f64(tm, card, card, case.exog),
                  lambda: newton_mod.residual_route(tm, card, card, case.exog, "auto"),
                  lambda: newton_mod.make_path_solver(case.J, case.exog, tm, card, card,
                                                      direction_dtype=f32,
                                                      direction_mode="xla")):
        with pytest.raises(ValueError, match=match):
            build()
    asked = count_on(monkeypatch, SMEM + 1)
    F = newton_mod.residual_route(tm, card, card, case.exog, "f64")
    assert not asked and torch.equal(F(x), newton_mod.make_full_residual_fn(
        tm, case.tss, case.tss, case.exog)(x))


def test_pair_refuses_grids_past_its_asset_states(case, monkeypatch):
    """Past 4096 (b, a) states (the global-list forward kernel's four
    sources a thread) the pair's build raises before asking the count;
    at 2112 (past the shared-list kernel's 2048) it builds on the
    global-list one."""
    het = case.tm.heterogeneity

    def grid(n_b, n_a):
        return dataclasses.replace(case.tm, heterogeneity={
            **het, "liquid": dataclasses.replace(het["liquid"], n=n_b),
            "illiquid": dataclasses.replace(het["illiquid"], n=n_a)})

    asked = count_on(monkeypatch, SMEM)
    card = on_card(case.tss)
    with pytest.raises(ValueError, match="4160 asset states.*residual_mode='f64'"):
        fr2.make_fused2_residual_fn_f64(grid(64, 65), card, card, case.exog)
    assert not asked
    F = fr2.make_fused2_residual_fn_f64(grid(64, 33), card, card, case.exog)
    assert F.forward_kernel == fr2.GLOBAL_LISTS
    n_e = het["income"].n
    assert sorted(asked) == [(0, fs2.default_bwd_cluster(n_e)),
                             (fr2.GLOBAL_LISTS, fs2.default_cluster(n_e))]


def test_cpu_routes_never_ask_the_count(case, monkeypatch):
    def refuse(*a):
        raise AssertionError("the count was asked off the card")

    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", refuse)
    for mode in ("auto", "ds"):
        newton_mod.residual_route(case.tm, case.tss, case.tss, case.exog, mode)
        newton_mod.make_path_solver(case.J, case.exog, case.tm, case.tss, case.tss,
                                    direction_dtype=f32, residual_mode=mode)


def solve_counts(case, method, x0, mode, **kw):
    """One solve with f32 directions through kernels 5-6's plain versions
    (`direction_mode="pallas"`), F by `residual_mode=mode`: (x, info, the
    sweeps of the f32 pair (matvecs and f32 residuals), the F calls)."""
    f64_calls = counts()
    sweeps = fs2.fused2_policies_jvp_reference.calls
    run = newton_mod.make_path_solver(case.J, case.exog, case.tm, case.tss, case.tss,
                                      method=method, direction_dtype=f32,
                                      direction_mode="pallas", residual_mode=mode, **kw)
    x, info = run(x0)
    after = counts()
    F_calls = after[0] - f64_calls[0] if mode == "ds" else after[4] - f64_calls[4]
    if mode == "ds":
        assert after[4] == f64_calls[4]      # no plain F
    return x, info, fs2.fused2_policies_jvp_reference.calls - sweeps, F_calls


@pytest.mark.parametrize("method", ["boehl", "newton_krylov"])
def test_solves_through_the_pair_follow_the_plain_route(case, method):
    """The boehl two-phase solve (Richardson, then the GMRES endgame) from
    x_ss and the Newton-Krylov solve from the linear start (two outers, cut
    for time: one in its f32-residual phase, one after the switch to F):
    with the pair as F ("ds") the same outers, matvecs and F calls as with
    the plain pipeline ("f64"), paths within 1e-10."""
    if method == "boehl":
        x0, kw = to_torch(case.x_ss), {"host_inner": True, "eps": 1e-10}
    else:
        x0 = linear_impulse_response(case.J, case.exog, case.tm, case.tss, case.tss,
                                     compute_residual=False)[0]
        kw = {"eps": 1e-10, "max_outer": 2, "gmres_restart": 8, "gmres_maxiter": 1}
    x_d, info_d, sweeps_d, F_d = solve_counts(case, method, x0, "ds", **kw)
    x_f, info_f, sweeps_f, F_f = solve_counts(case, method, x0, "f64", **kw)
    assert info_d["iterations"] == info_f["iterations"] > 0
    assert (sweeps_d, F_d) == (sweeps_f, F_f) and F_d > 0
    if method == "boehl":
        assert info_d["prof"]["sweep"]["calls"] > 0          # the Richardson phase ran
        assert all(info_d["prof"][k]["calls"] == info_f["prof"][k]["calls"]
                   for k in info_f["prof"])
    else:
        assert sweeps_d > 2 * info_d["iterations"]           # f32 residuals beside matvecs
    assert info_d["residual_norm"] == pytest.approx(info_f["residual_norm"], rel=1e-6, abs=1e-13)
    assert float((x_d - x_f).abs().max()) <= 1e-10


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_pair_on_card_matches_its_plain_version(case, cuda):
    """The pair on the card against its plain versions on the same inputs:
    F within 1e-11 (kernel 2's bound), policies pointwise within 1e-11, and
    two launches bit-identical."""
    tm = dataclasses.replace(case.tm, heterogeneity={
        k: dataclasses.replace(d, grid=d.grid.to(cuda),
                               transition=None if d.transition is None else d.transition.to(cuda))
        for k, d in case.tm.heterogeneity.items()})
    ss = dataclasses.replace(case.tss, value=case.tss.value.to(cuda), D=case.tss.D.to(cuda),
                             vars={k: torch.as_tensor(v).to(cuda) for k, v in case.tss.vars.items()})
    exog = {k: v.to(cuda) for k, v in case.exog.items()}
    x = to_torch(case.point("noisy")).to(cuda)
    launches = fr2.fused2_policies_f64.launches
    F = fr2.make_fused2_residual_fn_f64(tm, ss, ss, exog)
    F1, F2 = F(x), F(x)
    assert fr2.fused2_policies_f64.launches == launches + 2
    assert torch.equal(F1, F2)
    plain = newton_mod.make_full_residual_fn(tm, ss, ss, exog)(x)
    assert float((F1 - plain).abs().max()) <= 1e-11
    Tm1 = tm.compspec.T - 1
    prices = [q.contiguous() for q in fs2._fused2_price_hook(tm)(x.reshape(Tm1, -1), exog, tm)]
    pol = fr2.fused2_policies_f64(*prices, ss.value, tm)
    ref = fr2.fused2_policies_f64_reference(*prices, ss.value, tm)
    assert max(float((pol[k] - ref[k]).abs().max()) for k in KEYS) <= 1e-11
