"""Newton directions per solved path: launches of the single-path
direction kernels (kernel 1, the f64 tangent sweep, the two-asset
backward of either precision; every tier) over the paths solved."""

WRAPPERS = ("fused_sweep.fused_sweep_jvp.", "fused_sweep.fused_sweep_jvp_f64.",
            "fused_sweep2.fused2_policies_jvp.", "fused_sweep2.fused2_policies_jvp_f64.")


def read(run):
    n = sum(v for k, v in run.counters.items()
            if k.startswith(WRAPPERS) and not k.endswith(".calls"))
    return n / run.solved if n and run.solved else None
