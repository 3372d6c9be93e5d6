"""Lockstep direction sweeps per ensemble request: launches of the batched
direction kernels (kernels 3-4, the batched f64 tangent sweep, the batched
two-asset backward of either precision; every tier) per request."""

WRAPPERS = ("fused_sweep_batch.fused_sweep_jvp_batch.",
            "fused_sweep_batch.fused_sweep_jvp_f64_batch.",
            "fused_sweep2.fused2_policies_jvp_batch.",
            "fused_sweep2.fused2_policies_jvp_f64_batch.")


def read(run):
    n = sum(v for k, v in run.counters.items()
            if k.startswith(WRAPPERS) and not k.endswith(".calls"))
    return n / len(run.requests) if n else None
