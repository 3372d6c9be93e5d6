"""PyTorch port: two-asset f64 directions through the f64 tangent pair.

With f64 directions (`direction_dtype=None`, the default) the port's
`f64_direction_route` takes, for the two-asset Calvo-access family, the
f64 tangent pair (`ops/fused_sweep2.make_fused2_jvp_dir_f64`: kernels 5-6's
TANGENT instantiations in `csrc/household_sweep2_f64.cu`) under "pallas",
and under "auto" on the card; "xla", and "auto" on CPU tensors, take
`torch.func.jvp` of the plain f64 pipeline, as the reference does for
every f64 direction (`hank_tpu/solvers/newton.py:389`). On the small
two-asset model (24×12×4×2, T=12; `tests/test_torch_fused2_f64.py`'s
`Case`: the JAX package's steady state carried across), with inputs from a
numpy seed, this file holds:
  - the tangent pair's map (its plain versions) against `jax.jvp` of the
    JAX package's f64 F and against the port's AD route, to 1e-12 of the
    direction's scale, at three seeded points near x_ss;
  - the route each `direction_mode` takes on CPU tensors, counted;
  - "auto" on the card (a state that reports itself there, the library's
    count replaced): the tangent pair on the instantiations the counts
    pick, and ValueError naming direction_mode='xla' at the build past a
    block or past 4096 asset states;
  - transcriptions of the tangent instantiations' shared-memory counts
    and the decisions they give at 40×20×5×2 and 50×70×5×2;
  - a Newton-Krylov and a boehl solve through "pallas" on the AD route's
    path within 1e-9, with the same outers;
  - the boehl endgame's "f64-ad" rung under f32 directions: the f64 route
    `direction_mode` picks; at 64×64×5×2, where kernels 5-6 take the grid
    and the tangent pair does not, the mixed boehl and Newton-Krylov
    solvers raise at their build under "auto" and build as the error says.
The kernels themselves run only on a card (`gpu` marker): there each is
held to its plain version, its primal bit for bit to the values pair and
its instantiations bit for bit to one another, on seeded inputs. JAX is
imported inside the CPU tests only, so the card tests run without it:
`python -m pytest --noconftest -m gpu tests/test_torch_fused2_f64_directions.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_sweep2 as fs2

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64
KEYS = ("B", "A", "C")
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
WARPS = 32                      # the forward push's warps (1024 threads)
# The tangent pair's map against the JAX package's `jax.jvp` of its f64 F
# and the port's AD route: the same f64 arithmetic, sums in other orders.
RTOL = 1e-12


@pytest.fixture(scope="module")
def case():
    from tests.test_torch_fused2_f64 import Case

    return Case()


def to_torch(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=f64)


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), as the
    routes and the builds ask; the wrappers look at `device` and run their
    plain versions."""

    @property
    def is_cuda(self):
        return True


def on_card(ss):
    return dataclasses.replace(ss, value=ss.value.as_subclass(OnCard))


def points(case, seed):
    rng = np.random.default_rng(seed)
    x = case.x_ss * (1.0 + 0.002 * rng.normal(size=case.x_ss.shape))
    return x, rng.normal(size=case.x_ss.shape)


def counts():
    """(the pair's plain versions' calls, its kernels' launches, AD
    directions)."""
    return (fs2.fused2_policies_jvp_reference.calls, fs2.fused2_forward_jvp_reference.calls,
            fs2.fused2_policies_jvp_f64.launches + fs2.fused2_policies_jvp_f64.launches_global
            + fs2.fused2_forward_jvp_f64.launches + fs2.fused2_forward_jvp_f64.launches_global,
            newton_mod.ad_direction.calls)


def moved(before):
    return [a - b for a, b in zip(counts(), before)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tangent_pair_map_matches_jax_and_ad(case, seed):
    """The tangent pair's map (its plain versions: the price map, the pair,
    the f64 tail) against `jax.jvp` of the JAX package's f64 F and the
    port's AD route."""
    import jax
    import jax.numpy as jnp
    from hank_tpu.solvers.newton import make_full_residual_fn as jax_full

    x, v = points(case, seed)
    jF = jax_full(case.jm, case.jss, case.jss, {"G": jnp.asarray(case.G)})
    ref = np.asarray(jax.jvp(jF, (jnp.asarray(x),), (jnp.asarray(v),))[1])
    before = counts()
    out = fs2.make_fused2_jvp_dir_f64(case.tm, case.tss, case.tss, case.exog)(to_torch(x),
                                                                             to_torch(v))
    assert moved(before) == [1, 1, 0, 0]
    assert out.dtype == f64 and out.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert scale > 1.0
    assert float(np.max(np.abs(out.numpy() - ref))) <= RTOL * scale
    ad = newton_mod.f64_direction_route(case.tm, case.tss, case.tss, case.exog, "xla")
    assert float((out - ad(to_torch(x), to_torch(v))).abs().max()) <= RTOL * scale


@pytest.mark.parametrize("mode,moves", [("auto", [0, 0, 0, 1]), ("xla", [0, 0, 0, 1]),
                                        ("pallas", [1, 1, 0, 0])])
def test_f64_direction_mode_picks_the_route_on_the_cpu(case, mode, moves):
    """On CPU tensors "auto" and "xla" are AD, as in the reference; "pallas"
    takes the tangent pair's plain versions."""
    x, v = points(case, 3)
    before = counts()
    newton_mod.f64_direction_route(case.tm, case.tss, case.tss, case.exog, mode)(to_torch(x),
                                                                               to_torch(v))
    assert moved(before) == moves


def count_on(monkeypatch, count):
    """The f64 library's count replaced by `count(which)`; returns the list
    of (which, cluster) asked."""
    asked = []

    def counted(which, n_b, n_a, n_e, cluster=1):
        asked.append((which, cluster))
        return count(which)

    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", counted)
    return asked


def test_auto_on_the_card_takes_the_tangent_pair_or_raises_at_the_build(case, monkeypatch):
    """On the card "auto" builds the tangent pair (asking each kernel's
    count on its default cluster) on its shared-state backward and
    shared-list forward where they fit, the backward's global tangent
    state where its shared state has no room; one byte past every count
    the build raises ValueError naming direction_mode='xla', from the route
    and from the solver; "xla" asks no count and stays AD."""
    tm, card = case.tm, on_card(case.tss)
    n_e = tm.heterogeneity["income"].n
    C5, C6 = fs2.default_bwd_cluster(n_e), fs2.default_cluster(n_e)
    x, v = (to_torch(a) for a in points(case, 4))
    asked = count_on(monkeypatch, lambda which: SMEM)
    jvp_dir = newton_mod.f64_direction_route(tm, card, card, case.exog, "auto")
    assert (jvp_dir.backward_kernel, jvp_dir.forward_kernel) == (fs2.JVP_F64_BWD, 5)
    assert sorted(asked) == [(fs2.JVP_F64_BWD, C5), (fs2.JVP_F64_BWD, C5), (5, C6)]
    before = counts()
    out = jvp_dir(x, v)
    assert moved(before) == [1, 1, 0, 0]
    ad = newton_mod.f64_direction_route(case.tm, case.tss, case.tss, case.exog, "xla")(x, v)
    assert float((out - ad).abs().max()) <= RTOL * float(ad.abs().max())
    asked = count_on(monkeypatch, lambda which: SMEM + (which == fs2.JVP_F64_BWD))
    jvp_dir = fs2.make_fused2_jvp_dir_f64(tm, card, card, case.exog)
    assert (jvp_dir.backward_kernel, jvp_dir.forward_kernel) == (fs2.JVP_F64_BWD_GLOBAL, 5)
    assert (fs2.JVP_F64_BWD_GLOBAL, C5) in asked
    count_on(monkeypatch, lambda which: SMEM + 1)
    match = (f"f64 tangent pair at grid 24x12x{n_e}x2 needs {SMEM + 1} bytes.*"
             "direction_mode='xla'")
    with pytest.raises(ValueError, match=match):
        newton_mod.f64_direction_route(tm, card, card, case.exog, "auto")
    # The solver's build raises too: its residual (the values pair) first,
    # with the values pair's count in range.
    count_on(monkeypatch, lambda which: SMEM + (which >= 4))
    with pytest.raises(ValueError, match=match):
        newton_mod.make_path_solver(case.J, case.exog, tm, card, card)
    asked = count_on(monkeypatch, lambda which: SMEM + 1)
    before = counts()
    newton_mod.f64_direction_route(tm, card, card, case.exog, "xla")(x, v)
    assert not asked and moved(before) == [0, 0, 0, 1]


def test_tangent_pair_refuses_grids_past_its_asset_states(case, monkeypatch):
    """Past 4096 (b, a) states the tangent pair's build raises before asking
    a count; at 2112 (past the shared lists' 2048) it builds on the
    global-list forward push."""
    het = case.tm.heterogeneity
    asked = count_on(monkeypatch, lambda which: SMEM)
    card = on_card(case.tss)
    with pytest.raises(ValueError, match="4160 asset states.*direction_mode='xla'"):
        fs2.make_fused2_jvp_dir_f64(with_grid(case.tm, 64, 65), card, card, case.exog)
    assert not asked
    jvp_dir = fs2.make_fused2_jvp_dir_f64(with_grid(case.tm, 64, 33), card, card, case.exog)
    assert (jvp_dir.backward_kernel, jvp_dir.forward_kernel) == (fs2.JVP_F64_BWD, 6)
    assert (6, fs2.default_cluster(het["income"].n)) in asked


def test_cpu_tensors_never_ask_a_count(case, monkeypatch):
    def refuse(*a):
        raise AssertionError("the count was asked off the card")

    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", refuse)
    for mode in ("auto", "xla", "pallas"):
        newton_mod.f64_direction_route(case.tm, case.tss, case.tss, case.exog, mode)


# ── The counts ────────────────────────────────────────────────────────────

def bwd_smem(NB, NA, NE, C, tabled, state):
    """Transcription of `bwd_smem` (household_sweep2_f64.cu): per block, for
    the G = ⌈n_e / C⌉ incomes it has room for (n = G·n_b·n_a states, R =
    G·n_b rows), the state (5n doubles for the values kernel, 10n with the
    tangent state in shared memory, 7n with dW and the knots' tangents in
    the workspace), the rows' 9R, the grids, two periods' prices, the
    tangent rows' 3R, the tangents of a_next's weights and prices (n_a + 8),
    the brackets' indices (n_a ints) and the candidates' table (32 bytes,
    K·n_b of them) where it is tabled."""
    G, K = -(-NE // C), NA + NB + 2
    n, R = G * NB * NA, G * NB
    per_state = {"values": 5, "shared": 10, "global": 7}[state]
    tangent = 0 if state == "values" else 3 * R + NA + 8
    return (8 * (per_state * n + 9 * R + 2 * NA + 2 * NB + NE + NE * NE + 8 + tangent)
            + 4 * NA + (32 * K * NB if tabled else 0))


def bwd_fit(NB, NA, NE, C, state):
    """(tabled, bytes): tabled where the table fits, as `bwd_tabled`."""
    tabled = bwd_smem(NB, NA, NE, C, True, state) <= SMEM
    return tabled, bwd_smem(NB, NA, NE, C, tabled, state)


def fwd_smem(NB, NA, NE, C, global_lists, tangent):
    """Transcription of `fwd_shift` and `fwd_smem_bytes`: the least count
    shift that fits a block (or the largest), and the bytes there. TANGENT
    doubles the list entries, H, D and the warp partials."""
    NS, NG, kE = NB * NA, 2 * NE, 2 if tangent else 1
    G, nw, cells = -(-NG // C), -(-NS // 32), -(-NS // C)

    def size(shift):
        counts_ = ((nw - 1) >> shift) + 1
        lists = 4 * ((NS + 1) & ~1) if global_lists else 8 * kE * 4 * NS
        return (lists + 8 * (kE * (NG * cells + G * NS) + NB + NA + NE * NE + 4 + 3 * kE * WARPS)
                + 4 * ((NB + NA) * nw + NS + 4) + 2 * NS * counts_)

    shift = 0
    while (1 << shift) < nw and size(shift) > SMEM:
        shift += 1
    return shift, size(shift)


def test_values_transcriptions_are_the_large_grid_tests():
    """With the tangent off, the transcriptions are those
    `tests/test_torch_fused2_large_grid.py` holds the values pair to."""
    from tests.test_torch_fused2_large_grid import f64_bwd_smem, forward_smem

    for NB, NA, NE in ((24, 12, 4), (40, 20, 5), (50, 70, 5), (64, 64, 5)):
        C5, C6 = min(NE, 16), min(2 * NE, 16)
        for tabled in (True, False):
            assert bwd_smem(NB, NA, NE, C5, tabled, "values") == f64_bwd_smem(NB, NA, NE, C5,
                                                                             tabled)
        for global_lists in (False, True):
            assert fwd_smem(NB, NA, NE, C6, global_lists, False) == forward_smem(
                NB, NA, NE, C6, True, global_lists)


@pytest.mark.parametrize("grid,backward,forward", [
    ((40, 20, 5), ("shared", True, 148_768), (False, 0, 128_264)),
    ((50, 70, 5), ("global", False, 203_928), (True, 5, 223_544)),
])
def test_tangent_counts_at_the_two_published_grids(grid, backward, forward):
    """Counted before the kernels were written: at 40×20×5×2 the backward
    keeps its tangent state in shared memory (tabled) and the forward push
    its lists; at 50×70×5×2 the shared tangent state has no room (10n
    doubles: 287,928 bytes), dW and the knots' tangents go to the
    workspace (7n: 203,928), and the forward push takes global lists at
    count shift 5 (223,544)."""
    NB, NA, NE = grid
    C5, C6 = min(NE, 16), min(2 * NE, 16)
    state, tabled, need = backward
    shared = bwd_fit(NB, NA, NE, C5, "shared")
    assert (state == "shared") == (shared[1] <= SMEM)
    assert bwd_fit(NB, NA, NE, C5, state) == (tabled, need)
    global_lists, shift, fneed = forward
    assert (NB * NA > 2048 or fwd_smem(NB, NA, NE, C6, False, True)[1] > SMEM) == global_lists
    assert fwd_smem(NB, NA, NE, C6, global_lists, True) == (shift, fneed)
    if grid == (50, 70, 5):
        assert shared == (False, 287_928)


def with_grid(model, n_b, n_a):
    het = model.heterogeneity
    return dataclasses.replace(model, heterogeneity={
        **het, "liquid": dataclasses.replace(het["liquid"], n=n_b),
        "illiquid": dataclasses.replace(het["illiquid"], n=n_a)})


def transcribed_count(which, n_b, n_a, n_e, cluster=1):
    """The f64 library's count by the transcriptions."""
    if which in (0, 3):
        return bwd_smem(n_b, n_a, n_e, cluster, which == 0 and bwd_fit(
            n_b, n_a, n_e, cluster, "values")[0], "values")
    if which in (1, 2, 5, 6):
        return fwd_smem(n_b, n_a, n_e, cluster, which in (2, 6), which >= 5)[1]
    state = "shared" if which in (4, 7) else "global"
    return bwd_smem(n_b, n_a, n_e, cluster, which in (4, 8) and bwd_fit(
        n_b, n_a, n_e, cluster, state)[0], state)


@pytest.mark.parametrize("n_b,n_a,kernels", [(40, 20, (fs2.JVP_F64_BWD, 5)),
                                             (50, 70, (fs2.JVP_F64_BWD_GLOBAL, 6)),
                                             (64, 64, None)])
def test_the_maps_decide_by_the_counts(case, monkeypatch, n_b, n_a, kernels):
    """With the library's count the transcription's, the map built on the
    card records the instantiations step 1's counts pick at 40×20 and
    50×70, and at 64×64 (4096 states: neither the backward's 7n nor the
    forward push's global lists fit a block) the build raises."""
    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", transcribed_count)
    model, card = with_grid(case.tm, n_b, n_a), on_card(case.tss)
    model = dataclasses.replace(model, heterogeneity={
        **model.heterogeneity, "income": dataclasses.replace(model.heterogeneity["income"], n=5)})
    if kernels is None:
        with pytest.raises(ValueError, match="f64 tangent pair at grid 64x64x5x2"):
            fs2.make_fused2_jvp_dir_f64(model, card, card, case.exog)
        return
    jvp_dir = fs2.make_fused2_jvp_dir_f64(model, card, card, case.exog)
    assert (jvp_dir.backward_kernel, jvp_dir.forward_kernel) == kernels


# ── Solves and the endgame's rung ─────────────────────────────────────────

@pytest.mark.parametrize("method,kw", [
    ("newton_krylov", {"gmres_restart": 8, "gmres_maxiter": 1}),
    ("boehl", {"host_inner": True, "richardson_max_outer": 0})])
def test_solves_through_the_tangent_pair_match_ad(case, method, kw):
    """The same solve from the linear start with f64 directions through the
    tangent pair's plain versions ("pallas") and by AD ("xla"), to 1e-10:
    the same outers, the same path within 1e-9 (GMRES cut to one cycle of
    8, the boehl solve to its endgame, for time)."""
    from hank_tpu_torch.solvers.linear import linear_impulse_response

    x0 = linear_impulse_response(case.J, case.exog, case.tm, case.tss, case.tss,
                                 compute_residual=False)[0]
    paths, outers = {}, {}
    for mode in ("pallas", "xla"):
        before = counts()
        x, info = newton_mod.make_path_solver(case.J, case.exog, case.tm, case.tss, case.tss,
                                              method=method, direction_mode=mode, eps=1e-10,
                                              **kw)(x0)
        assert info["residual_norm"] < 1e-10
        d = moved(before)
        assert (d[0] > 0, d[3] > 0) == ((True, False) if mode == "pallas" else (False, True))
        paths[mode], outers[mode] = x, info["iterations"]
    assert outers["pallas"] == outers["xla"] > 0
    assert float((paths["pallas"] - paths["xla"]).abs().max()) <= 1e-9


@pytest.mark.parametrize("direction_mode", ["auto", "xla", "pallas"])
def test_f64_ad_rung_is_the_f64_route_under_f32_directions(case, monkeypatch, direction_mode):
    """Under f32 directions the boehl endgame's "f64-ad" rung is the f64
    route `direction_mode` picks: the tangent pair under "pallas" and under
    "auto" on the card (here with the count in range), AD under "xla" and
    under "auto" on CPU tensors."""
    routes = []
    route = newton_mod.f64_direction_route

    def recorded(*a):
        routes.append(a[-1])
        jvp_dir = route(*a)
        routes.append(jvp_dir)
        return jvp_dir

    monkeypatch.setattr(newton_mod, "f64_direction_route", recorded)
    count_on(monkeypatch, lambda which: SMEM)
    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", lambda *a: SMEM)     # kernels 5-6
    fs2_calls = fs2.fused2_policies_jvp_reference.calls
    for ss in (case.tss, on_card(case.tss)):
        routes.clear()
        newton_mod.make_path_solver(case.J, case.exog, case.tm, ss, ss, method="boehl",
                                    direction_dtype=f32, direction_mode=direction_mode,
                                    host_inner=True)
        assert routes[0] == direction_mode
        pair = direction_mode == "pallas" or (direction_mode == "auto" and ss is not case.tss)
        assert hasattr(routes[1], "backward_kernel") == pair
        assert routes[1].__qualname__.startswith("ad_direction") != pair
    assert fs2.fused2_policies_jvp_reference.calls == fs2_calls     # built, not run


def kernels56_count(which, n_b, n_a, n_e, cluster=1):
    """Kernels 5-6's library count by `tests/test_torch_fused2_large_grid.py`'s
    transcriptions (3 kernel 5, 2 and 4 kernel 6's shared and global lists)."""
    from tests.test_torch_fused2_large_grid import bwd_cluster_smem_bytes, forward_smem

    if which == 3:
        return bwd_cluster_smem_bytes(n_b, n_a, n_e, cluster)[1]
    return forward_smem(n_b, n_a, n_e, cluster, global_lists=which == 4)[1]


@pytest.mark.parametrize("method,kw,leave_out", [
    ("boehl", {"host_inner": True}, {"endgame": "fd"}),
    ("newton_krylov", {}, {"stall_rescue": False})])
def test_f32_solvers_past_the_tangent_pair_build_where_the_error_says(case, monkeypatch, method,
                                                                     kw, leave_out):
    """At 64×64×5×2 on the card, with both libraries' counts the
    transcriptions', kernels 5-6 and the f64 residual pair take the grid
    and the tangent pair does not: the mixed boehl host-PGMRES solver and
    the mixed Newton-Krylov one (whose stall rescue is that boehl solve)
    raise when they are built under "auto", naming direction_mode='xla' and
    the option that leaves the f64 rung out; built with either, they
    build. Under "xla" no tangent count is asked."""
    asked = []

    def f64_count(which, *grid):
        asked.append(which)
        return transcribed_count(which, *grid)

    monkeypatch.setattr(cuda_build, "sweep2_f64_smem_bytes", f64_count)
    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", kernels56_count)
    model = with_grid(case.tm, 64, 64)
    model = dataclasses.replace(model, heterogeneity={
        **model.heterogeneity, "income": dataclasses.replace(model.heterogeneity["income"], n=5)})
    card = on_card(case.tss)

    def build(mode, **extra):
        asked.clear()
        return newton_mod.make_path_solver(case.J, case.exog, model, card, card, method=method,
                                           direction_dtype=f32, direction_mode=mode,
                                           **kw, **extra)

    option = "".join(f"{k}={v!r}" for k, v in leave_out.items())
    with pytest.raises(ValueError, match=("f64 tangent pair at grid 64x64x5x2 needs.*"
                                          f"direction_mode='xla'.*or {option}")):
        build("auto")
    assert asked and max(asked) >= fs2.JVP_F64_BWD
    build("xla")
    assert asked and max(asked) < fs2.JVP_F64_BWD             # the values pair's only
    build("auto", **leave_out)
    assert asked and max(asked) < fs2.JVP_F64_BWD


# ── On the card ────────────────────────────────────────────────────────────

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.gpu
def test_tangent_pair_on_card_matches_its_plain_version(cuda):
    """On seeded inputs (`tests/test_torch_fused2_batch.py`'s): each kernel
    within 1e-9·max(scale, 1) of its plain version in f64, its primal bit
    for bit the values pair, a zero tangent exactly zero, and every
    instantiation (the backward's global tangent state and untabled
    branches, the forward push's global lists) bit for bit the one the
    route takes; a NaN price gives NaN tangents."""
    from hank_tpu_torch.ops import fused_residual2 as fr2
    from test_torch_fused2_batch import same_bits, seeded_inputs

    tm, prices, tangents, VT, D0 = seeded_inputs(cuda, B=2, nan_row=1)
    p = [q[0].contiguous() for q in prices]
    d = [q[0].contiguous() for q in tangents]
    pol, dpol = fs2.fused2_policies_jvp_f64(*p, *d, VT, tm)
    ref, dref = fs2.fused2_policies_jvp_reference(*p, *d, VT, tm)
    values = fr2.fused2_policies_f64(*p, VT, tm)
    for k in KEYS:
        assert same_bits(pol[k], values[k]), k
        assert float((dpol[k] - dref[k]).abs().max()) <= 1e-9 * max(
            float(dref[k].abs().max()), 1.0), k
    for which in (fs2.JVP_F64_BWD_UNTABLED, fs2.JVP_F64_BWD_GLOBAL,
                  fs2.JVP_F64_BWD_GLOBAL_UNTABLED):
        p2, d2 = fs2._launch_bwd_jvp_f64([*p, *d], VT, tm, which)
        assert all(same_bits(pol[k], p2[k]) and same_bits(dpol[k], d2[k]) for k in KEYS), which
    aggs, daggs = fs2.fused2_forward_jvp_f64(pol, dpol, D0, tm)
    ragg, rdagg = fs2.fused2_forward_jvp_reference(pol, dpol, D0, tm)
    vaggs = fr2.fused2_forward_f64(pol, D0, tm)
    for k in KEYS:
        assert same_bits(aggs[k], vaggs[k]), k
        assert float((daggs[k] - rdagg[k]).abs().max()) <= 1e-9 * max(
            float(rdagg[k].abs().max()), 1.0), k
    tensors = [*(pol[k] for k in KEYS), *(dpol[k] for k in KEYS), D0]
    a2, d2 = fs2._launch_fwd_jvp_f64(tensors, pol["B"].shape[0], tm, 6,
                                     fs2.default_cluster(tm.heterogeneity["income"].n))
    assert all(same_bits(aggs[k], a2[k]) and same_bits(daggs[k], d2[k]) for k in KEYS)
    zero = [torch.zeros_like(q) for q in d]
    _, dz = fs2.fused2_policies_jvp_f64(*p, *zero, VT, tm)
    _, daz = fs2.fused2_forward_jvp_f64(pol, dz, D0, tm)
    assert all(bool((t == 0).all()) for t in (*dz.values(), *daz.values()))
    _, dn = fs2.fused2_policies_jvp_f64(*(q[1].contiguous() for q in (*prices, *tangents)),
                                        VT, tm)
    assert not all(bool(torch.isfinite(dn[k]).all()) for k in KEYS)


@pytest.mark.gpu
def test_library_counts_are_the_transcriptions(cuda):
    """The library's own counts of the tangent instantiations (and the
    values pair's) equal the transcriptions, at the small grid and the two
    published ones."""
    for n_b, n_a, n_e in ((24, 12, 4), (40, 20, 5), (50, 70, 5), (48, 64, 5)):
        for which in range(10):
            C = min(n_e, 16) if which in (0, 3, 4, 7, 8, 9) else min(2 * n_e, 16)
            assert cuda_build.sweep2_f64_smem_bytes(which, n_b, n_a, n_e, C) == \
                transcribed_count(which, n_b, n_a, n_e, C), (which, n_b, n_a)
