"""PyTorch port: the kernel maps hold the grid to shared memory, on the CPU.

On the card every kernel map is held, when it is built, to the shared
memory its kernel needs at the model's grid (`ops/cuda_build.check_fit` of
the library's own count, from `fused_sweep.sweep_setup` and
`fused_sweep2._build_fused2`). A one-asset map whose one-block kernel does
not take the grid builds on that kernel's global-state instantiation
(`fused_sweep.sweep_kernel`: a decision by the counts, before any launch);
past that one's count, and past a two-asset kernel's, the build raises
ValueError, under "auto" as under "pallas"/"ds", before a solve starts and
before any launch, and the message names the plain routes ("xla", "f64")
that take the grid. No route falls back to a plain version on the card.
The reference degrades instead, after its probes
(`hank_tpu/solvers/newton.py:356-376, 431-450`).

Without a card the library cannot count, so the tests count with Python
transcriptions of `csrc/household_sweep.cu`'s `smem_bytes<S, TANGENT>`,
`jvp_smem_bytes`, `global_smem_bytes<S, TANGENT>` and the two forward
scans' counts (kernels 5-6 reuse
`tests/test_torch_bwd_schedule.py`'s and `tests/test_torch_lottery_schedule.py`'s)
and hand them to the check through `cuda_build.sweep_smem_bytes`; the steady
state is made to report its arrays on the card (`OnCard`), while the
wrappers, which look at the device, still run their plain versions.
`chip_smoke.py` holds the library's count to the same limits on the card.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import hank_tpu_torch.parallel.ensemble as ensemble_mod
import hank_tpu_torch.solvers.newton as newton_mod
from hank_tpu_torch.ops import cuda_build
from hank_tpu_torch.ops import fused_sweep2 as fs2
from hank_tpu_torch.ops.fused_residual import fused_residual_sweep_reference
from hank_tpu_torch.ops.fused_sweep import KERNEL_NAMES, fused_sweep_jvp_reference, sweep_setup
from hank_tpu_torch.utils.checkpoint import steady_state_from_numpy
from tests.test_torch_bwd_schedule import cluster_smem_bytes as k5_bytes
from tests.test_torch_common import (build_small_ks_torch, build_small_two_asset_torch,
                                     ss_to_numpy, to_torch, transitory_exog)
from tests.test_torch_lottery_schedule import cluster_smem_bytes as k6_bytes
from tests.test_torch_solve import x_ss_of

torch.set_num_threads(1)
f32, f64 = torch.float32, torch.float64
SMEM = 232_448                  # dynamic shared memory of one block (227 KB)
K_THREADS = 1024
PLAIN = "only the plain routes take this grid (direction_mode='xla', residual_mode='f64')"


# ── transcriptions of the library's counts ────────────────────────────────

def smem_bytes(size, tangent, n_a, n_e):
    """`smem_bytes<S, TANGENT>`: the counting template's layout, which the
    ranged kernel (kernels 2-4, the f64 tangent sweep) takes byte for byte."""
    n = n_a * n_e
    return size * ((6 if tangent else 3) * n + 5 * n_a + n_e + n_e * n_e
                   + (4 if tangent else 2) * K_THREADS)


def jvp_smem_bytes(n_a, n_e):
    """Kernel 1: the template's f32 dual layout and two int flags a row."""
    return smem_bytes(4, True, n_a, n_e) + 2 * 4 * n_e


def global_smem_bytes(size, tangent, n_a, n_e):
    """`global_smem_bytes<S, TANGENT>`: the global-state instantiations keep
    the grid arrays, labor, Pi and the reduction slots in shared memory."""
    return size * (5 * n_a + n_e + n_e * n_e + (4 if tangent else 2) * K_THREADS)


def forward_scan_previous_smem_bytes(n_a, n_e):
    return 4 * (3 * n_a * n_e + 5 * n_a + n_e * n_e + K_THREADS)


def forward_scan_smem_bytes(n_a, n_e):
    """Kernel 7's serial kernel: D, D_half, the clamped row, four hat arrays
    and Pi (its pre-pass takes one row, 4 n_a)."""
    return 4 * (3 * n_a * n_e + 4 * n_a + n_e * n_e)


BYTES = {
    cuda_build.PREVIOUS_KERNEL2: lambda n_a, n_e: smem_bytes(8, False, n_a, n_e),
    cuda_build.PREVIOUS_KERNELS3_4: lambda n_a, n_e: smem_bytes(4, True, n_a, n_e),
    cuda_build.KERNEL1: jvp_smem_bytes,
    cuda_build.KERNELS3_4: lambda n_a, n_e: smem_bytes(4, True, n_a, n_e),
    cuda_build.KERNEL2: lambda n_a, n_e: smem_bytes(8, False, n_a, n_e),
    cuda_build.JVP_F64: lambda n_a, n_e: smem_bytes(8, True, n_a, n_e),
    cuda_build.PREVIOUS_JVP_F64: lambda n_a, n_e: smem_bytes(8, True, n_a, n_e),
    cuda_build.GLOBAL_KERNEL1: lambda n_a, n_e: global_smem_bytes(4, True, n_a, n_e),
    cuda_build.GLOBAL_KERNELS3_4: lambda n_a, n_e: global_smem_bytes(4, True, n_a, n_e),
    cuda_build.GLOBAL_KERNEL2: lambda n_a, n_e: global_smem_bytes(8, False, n_a, n_e),
    cuda_build.GLOBAL_JVP_F64: lambda n_a, n_e: global_smem_bytes(8, True, n_a, n_e),
}

# The last n_a each kernel takes at n_e = 7.
LIMITS = {"kernel2": (cuda_build.KERNEL2, 1036), "kernel1": (cuda_build.KERNEL1, 1147),
          "kernels3_4": (cuda_build.KERNELS3_4, 1148), "jvp_f64": (cuda_build.JVP_F64, 529)}
# The last n_a each global-state instantiation takes at n_e = 7.
GLOBAL_LIMITS = {"kernel2": (cuda_build.GLOBAL_KERNEL2, 5390),
                 "kernel1": (cuda_build.GLOBAL_KERNEL1, 10792),
                 "kernels3_4": (cuda_build.GLOBAL_KERNELS3_4, 10792),
                 "jvp_f64": (cuda_build.GLOBAL_JVP_F64, 4980)}


class OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card (`is_cuda`), as the
    routes and the kernel maps ask; the wrappers look at `device` and run
    their plain versions."""

    @property
    def is_cuda(self):
        return True


def on_card(ss):
    return dataclasses.replace(ss, value=ss.value.as_subclass(OnCard))


@pytest.fixture
def count(monkeypatch):
    """The transcriptions in place of the library's count; returns the
    list of the `which` asked."""
    asked = []

    def counted(which, n_a, n_e):
        asked.append(which)
        return BYTES[which](n_a, n_e)

    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", counted)
    return asked


@pytest.fixture
def over(monkeypatch):
    """Every one-asset (the global-state instantiations too) and two-asset
    kernel one byte past a block."""
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: SMEM + 1)
    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", lambda *a: SMEM + 1)


def one_block_over(n_a, n_e, which):
    """Every one-block one-asset kernel one byte past a block; the
    global-state instantiations at the transcription's count."""
    return SMEM + 1 if which in cuda_build.GLOBAL_STATE else BYTES[which](n_a, n_e)


@pytest.fixture
def past_one_block(monkeypatch):
    """`one_block_over` as the library's count; returns the list of the
    `which` asked."""
    asked = []

    def counted(which, n_a, n_e):
        asked.append(which)
        return one_block_over(n_a, n_e, which)

    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", counted)
    return asked


def test_check_fit_is_the_block_limit():
    assert cuda_build.MAX_SMEM_BYTES == SMEM
    cuda_build.check_fit(SMEM, "grid")
    with pytest.raises(ValueError, match=f"grid needs {SMEM + 1} bytes of shared memory; "
                                         f"one block has {SMEM}; try"):
        cuda_build.check_fit(SMEM + 1, "grid", "; try")


@pytest.mark.parametrize("name", sorted(LIMITS))
def test_decision_at_each_limit_and_one_past_it(ks, count, name):
    """At n_e = 7: kernel 2 takes n_a ≤ 1036, kernel 1 ≤ 1147, kernels 3-4
    ≤ 1148, the f64 tangent sweep ≤ 529; one knot more and the map builds
    on the kernel's global-state instantiation, decided by the counts."""
    which, last = LIMITS[name]
    tss = on_card(ks[1])
    dtype = f32 if which in (cuda_build.KERNEL1, cuda_build.KERNELS3_4) else f64
    setup = sweep_setup(build_small_ks_torch(T=12, n_a=last, n_e=7), tss, tss, dtype, which)
    assert setup.kernel == which
    model = build_small_ks_torch(T=12, n_a=last + 1, n_e=7)
    assert sweep_setup(model, tss, tss, dtype, which).kernel == cuda_build.GLOBAL_STATE[which]
    assert BYTES[which](last + 1, 7) > SMEM
    assert count == [which, which, cuda_build.GLOBAL_STATE[which]]


@pytest.mark.parametrize("name", sorted(GLOBAL_LIMITS))
def test_decision_at_each_global_state_limit_and_one_past_it(ks, count, name):
    """At n_e = 7 the global-state instantiations take n_a ≤ 5390 (kernel
    2's place), ≤ 10792 (kernel 1's and kernels 3-4's), ≤ 4980 (the f64
    tangent sweep's); one knot more and the map's build raises, naming the
    instantiation, its bytes and the plain routes."""
    which, last = GLOBAL_LIMITS[name]
    one_block = LIMITS[name][0]
    tss = on_card(ks[1])
    dtype = f32 if one_block in (cuda_build.KERNEL1, cuda_build.KERNELS3_4) else f64
    setup = sweep_setup(build_small_ks_torch(T=12, n_a=last, n_e=7), tss, tss, dtype,
                        one_block)
    assert setup.kernel == which
    model = build_small_ks_torch(T=12, n_a=last + 1, n_e=7)
    with pytest.raises(ValueError) as err:
        sweep_setup(model, tss, tss, dtype, one_block)
    text = str(err.value)
    assert text.startswith(f"{KERNEL_NAMES[which]} at grid {last + 1}x7 needs "
                           f"{BYTES[which](last + 1, 7)} bytes of shared memory")
    assert text.endswith(PLAIN)
    assert count == [one_block, which] * 2


def test_kernel7_takes_every_grid_the_previous_kernel7_takes():
    """Kernel 7's serial kernel, and its pre-pass, fit every grid (n_a ≥ 2,
    n_e ≤ 20) the previous kernel 7 fits in one block."""
    taken = 0
    for n_e in range(1, 21):
        n_a = 2
        while forward_scan_previous_smem_bytes(n_a, n_e) <= SMEM:
            taken += 1
            assert forward_scan_smem_bytes(n_a, n_e) <= SMEM and 4 * n_a <= SMEM
            assert n_a < 32768                      # the packed source ranges
            n_a += 1
    assert taken > 40_000


def test_two_asset_pair_decision():
    """Kernels 5-6 on their default clusters at the published 40×20×5×2 grid
    fit (the transcriptions of both counts)."""
    k5 = k5_bytes(40, 20, 5, fs2.default_bwd_cluster(5))[1]
    k6 = k6_bytes(40, 20, 5, fs2.default_cluster(5))[1]
    assert max(k5, k6) <= SMEM


@pytest.fixture(scope="module")
def ks(ks_small, ks_small_ss):
    T = ks_small.compspec.T
    tm = build_small_ks_torch(T=T)
    tss = steady_state_from_numpy(ss_to_numpy(ks_small_ss), device="cpu")
    x = to_torch(x_ss_of(ks_small, ks_small_ss)) * 1.001
    return tm, tss, {"Z": to_torch(transitory_exog(T))}, x


def two_asset_pair_on(monkeypatch, nbytes):
    calls = []

    def counted(which, n_b, n_a, n_e, cluster=1):
        calls.append((which, cluster))
        return nbytes

    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", counted)
    return calls


def test_two_asset_pair_build_asks_both_kernels(monkeypatch):
    """On the card the kernel pair's build asks kernels 5 and 6 on their
    default clusters and raises when either is past a block; the plain
    pair asks nothing."""
    model = build_small_two_asset_torch()
    n_e = model.exog_dims()[0].n
    ss = type("SS", (), {"vars": {}, "D": torch.zeros(1),
                         "value": torch.zeros(1).as_subclass(OnCard)})()
    calls = two_asset_pair_on(monkeypatch, SMEM)
    fs2.make_fused2_jvp_dir(model, ss, ss, {})
    assert sorted(calls) == sorted([(3, fs2.default_bwd_cluster(n_e)),
                                    (2, fs2.default_cluster(n_e))])
    calls = two_asset_pair_on(monkeypatch, SMEM + 1)
    with pytest.raises(ValueError, match=f"kernels 5-6 at grid 24x12x{n_e}x2 needs"):
        fs2.make_fused2_jvp_dir(model, ss, ss, {})
    calls.clear()
    fs2.make_fused2_jvp_dir(model, ss, ss, {}, plain=True)
    assert not calls


def test_auto_f32_direction_route_takes_kernel1_or_raises(ks, count, monkeypatch):
    """On the card "auto" builds kernel 1's map (its plain version here)
    where it fits, and past its limit the map of its global-state
    instantiation; past that one's count the build raises, and "xla" builds
    the mixed-tail map without asking."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    v = torch.ones_like(x)
    calls = fused_sweep_jvp_reference.calls
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        newton_mod.direction_route(tm, card, card, exog, "auto")[0](x, v)
    assert fused_sweep_jvp_reference.calls == calls + 1 and set(count) == {cuda_build.KERNEL1}
    count.clear()
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: count.append(w) or one_block_over(n_a, n_e, w))
    newton_mod.direction_route(tm, card, card, exog, "auto")[0](x, v)
    assert fused_sweep_jvp_reference.calls == calls + 2
    assert set(count) == {cuda_build.KERNEL1, cuda_build.GLOBAL_KERNEL1}
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: SMEM + 1)
    with pytest.raises(ValueError, match="the global-state f32 tangent sweep .* needs"):
        newton_mod.direction_route(tm, card, card, exog, "auto")
    jvp_dir, _ = newton_mod.direction_route(tm, card, card, exog, "xla")
    mixed, _ = newton_mod.mixed_tail_map(tm, tss, tss)
    assert torch.equal(jvp_dir(x, v), mixed(x, v, exog))


def test_auto_f64_direction_route_takes_the_f64_sweep_or_raises(ks, count, monkeypatch):
    """On the card "auto" builds the f64 tangent sweep's map (its plain
    version here) where it fits, and past its limit the map of its
    global-state instantiation, with no AD direction; past that one's count
    the build raises, and "xla" is AD."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    v = torch.ones_like(x)
    calls, ad = fused_sweep_jvp_reference.calls, newton_mod.ad_direction.calls
    newton_mod.f64_direction_route(tm, card, card, exog, "auto")(x, v)
    assert (fused_sweep_jvp_reference.calls, newton_mod.ad_direction.calls) == (calls + 1, ad)
    assert count == [cuda_build.JVP_F64]
    count.clear()
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: count.append(w) or one_block_over(n_a, n_e, w))
    newton_mod.f64_direction_route(tm, card, card, exog, "auto")(x, v)
    assert (fused_sweep_jvp_reference.calls, newton_mod.ad_direction.calls) == (calls + 2, ad)
    assert count == [cuda_build.JVP_F64, cuda_build.GLOBAL_JVP_F64]
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", lambda *a: SMEM + 1)
    with pytest.raises(ValueError,
                       match="the global-state f64 tangent sweep at grid 40x5 needs"):
        newton_mod.f64_direction_route(tm, card, card, exog, "auto")
    newton_mod.f64_direction_route(tm, card, card, exog, "xla")(x, v)
    assert newton_mod.ad_direction.calls == ad + 1


def test_kernel2_residual_routes_raise_past_the_limit(ks, over, monkeypatch):
    """Past kernel 2's one-block limit "auto" and "ds" build on its
    global-state instantiation (its plain version here: the same F as the
    plain f64 pipeline); past that one's count they raise when the residual
    is built; "f64" takes the plain f64 pipeline."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    for mode in ("auto", "ds"):
        with pytest.raises(ValueError, match="the global-state f64 residual sweep .* needs"):
            newton_mod.residual_route(tm, card, card, exog, mode)
    F = newton_mod.residual_route(tm, card, card, exog, "f64")
    plain = newton_mod.make_full_residual_fn(tm, tss, tss, exog)(x)
    assert torch.equal(F(x), plain)
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: one_block_over(n_a, n_e, w))
    for mode in ("auto", "ds"):
        calls = fused_residual_sweep_reference.calls
        F = newton_mod.residual_route(tm, card, card, exog, mode)
        assert float((F(x) - plain).abs().max()) <= 1e-12
        assert fused_residual_sweep_reference.calls == calls + 1


def test_explicit_pallas_modes_raise_at_the_build(ks, over, monkeypatch):
    """"pallas" past the global-state instantiations' counts raises when
    the map is built, not at its first launch; past the one-block kernels'
    alone it builds on the global-state ones."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    with pytest.raises(ValueError, match="the global-state f32 tangent sweep .* needs"):
        newton_mod.direction_route(tm, card, card, exog, "pallas")
    with pytest.raises(ValueError, match="the global-state f64 tangent sweep .* needs"):
        newton_mod.f64_direction_route(tm, card, card, exog, "pallas")
    asked = []
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: asked.append(w) or one_block_over(n_a, n_e, w))
    newton_mod.direction_route(tm, card, card, exog, "pallas")
    newton_mod.f64_direction_route(tm, card, card, exog, "pallas")
    assert set(asked) == {cuda_build.KERNEL1, cuda_build.GLOBAL_KERNEL1,
                          cuda_build.JVP_F64, cuda_build.GLOBAL_JVP_F64}


def test_path_solver_raises_at_the_build_past_the_limits(ks, over, monkeypatch):
    """`make_path_solver` with the defaults (f64 directions, kernel-2
    residual) past every limit, the global-state instantiations' included,
    raises before a solve; the plain routes build and solve, without a
    warning. Past the one-block limits alone the defaults build on the
    global-state instantiations."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    J = torch.eye(x.shape[0], dtype=f64)
    for kw in ({}, {"direction_dtype": f32}, {"residual_mode": "f64"}):
        with pytest.raises(ValueError, match=PLAIN.replace("(", r"\(").replace(")", r"\)")):
            newton_mod.make_path_solver(J, exog, tm, card, card, method="boehl", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        run = newton_mod.make_path_solver(J, exog, tm, card, card, method="boehl",
                                          max_outer=1, max_inner=1, direction_mode="xla",
                                          residual_mode="f64")
    ad = newton_mod.ad_direction.calls
    run(x)
    assert newton_mod.ad_direction.calls > ad
    asked = []
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: asked.append(w) or one_block_over(n_a, n_e, w))
    for kw in ({}, {"direction_dtype": f32}):
        asked.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("error", UserWarning)
            newton_mod.make_path_solver(J, exog, tm, card, card, method="boehl", **kw)
        assert {w for w in asked if w in cuda_build.GLOBAL_STATE.values()} == {
            cuda_build.GLOBAL_KERNEL2,
            cuda_build.GLOBAL_KERNEL1 if kw else cuda_build.GLOBAL_JVP_F64}


def test_ensemble_routes_raise_past_the_limits(ks, over, monkeypatch):
    """Past every limit the ensemble's kernel-2 residual and its batched
    f32 direction map raise when built; f64 ensemble directions take the
    plain route. Past the one-block limits alone both build on the
    batched global-state instantiations."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    B = 2
    exog_b = {k: v[None].expand(B, -1).contiguous() for k, v in exog.items()}
    x_b = x[None].expand(B, -1).contiguous()
    with pytest.raises(ValueError, match="the global-state f64 residual sweep .* needs"):
        ensemble_mod.residual_ensemble(x_b, exog_b, tm, card, card)
    J = torch.eye(x.shape[0], dtype=f64)
    with pytest.raises(ValueError, match="the global-state f64 residual sweep .* needs"):
        ensemble_mod.solve_ensemble_host(x, J, exog_b, tm, card, card, max_outer=1)
    ensemble_mod.solve_ensemble_host(x, J, exog_b, tm, card, card, max_outer=1,
                                     direction_dtype=None)
    asked = []
    monkeypatch.setattr(cuda_build, "sweep_smem_bytes",
                        lambda w, n_a, n_e: asked.append(w) or one_block_over(n_a, n_e, w))
    F_b = ensemble_mod.residual_ensemble(x_b, exog_b, tm, card, card)
    assert float((F_b[0] - newton_mod.make_full_residual_fn(tm, tss, tss, exog)(x))
                 .abs().max()) <= 1e-12
    ensemble_mod.solve_ensemble_host(x, J, exog_b, tm, card, card, max_outer=1)
    assert {w for w in asked if w in cuda_build.GLOBAL_STATE.values()} == {
        cuda_build.GLOBAL_KERNEL2, cuda_build.GLOBAL_KERNELS3_4}


@pytest.mark.parametrize("mode", ["pallas", "auto"])
def test_f32_boehl_endgame_builds_no_f64_kernel_map(ks, count, mode):
    """f32 directions with the boehl host-PGMRES endgame at 530×7, where
    kernels 1-2 fit and the f64 tangent sweep does not: the solver builds,
    and its "f64-ad" rung is AD, not the f64 tangent sweep."""
    tm, tss, exog, x = ks
    card = on_card(tss)
    model = build_small_ks_torch(T=tm.compspec.T, n_a=530, n_e=7)
    J = torch.eye(x.shape[0], dtype=f64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        newton_mod.make_path_solver(J, exog, model, card, card, method="boehl",
                                    direction_dtype=f32, direction_mode=mode,
                                    host_inner=True)
    assert set(count) == {cuda_build.KERNEL2, cuda_build.KERNEL1}


def test_cpu_routes_never_ask_the_count(ks, monkeypatch):
    """On CPU tensors no route asks the library (there is none here)."""
    tm, tss, exog, x = ks

    def refuse(*a):
        raise AssertionError("the count was asked off the card")

    monkeypatch.setattr(cuda_build, "sweep_smem_bytes", refuse)
    monkeypatch.setattr(cuda_build, "sweep2_smem_bytes", refuse)
    J = torch.eye(x.shape[0], dtype=f64)
    for dtype in (f32, None):
        for mode in ("auto", "pallas"):
            newton_mod.make_path_solver(J, exog, tm, tss, tss, direction_dtype=dtype,
                                        direction_mode=mode)
    ensemble_mod.residual_ensemble(x[None], {k: v[None] for k, v in exog.items()},
                                   tm, tss, tss)
    assert np.isfinite(float(newton_mod.residual_route(tm, tss, tss, exog)(x).norm()))
