"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches
its kernel for CUDA tensors (or raises); there is no fallback between
the two.  ``LAUNCHES`` counts kernel launches per wrapper: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels.
"""

import torch

LAUNCHES = {
    "segsum_sorted": 0, "adam_rows": 0, "ftrl_rows": 0,
    "segsum_unsorted": 0, "adam_cols": 0, "ftrl_cols": 0, "gather_rows": 0,
    "segsum_cols": 0, "gather_cols": 0, "fused_adam_gather": 0,
    "fused_ftrl_gather": 0,
    # launches of adam_cols / ftrl_cols (counted there too) that read the
    # summed gradients in place (update_cols.adam_cols_from_sums /
    # ftrl_cols_from_sums)
    "cols_in_place": 0,
    # the multitable feature assembly, forward and backward (assemble.py)
    "assemble_fwd": 0, "assemble_bwd": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require(cond: bool, name: str, what: str) -> None:
    """Raise ``ValueError`` naming the wrapper when a check fails."""
    if not cond:
        raise ValueError(f"{name}: {what}")


def on_cpu(name: str, *tensors) -> bool:
    """True when every tensor is on the CPU, False when every one is on
    CUDA (one device); raises for a mix or any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return True
    require(types == {"cuda"} and len({t.device for t in tensors}) == 1,
            name, f"tensors must all be on the CPU or one CUDA device, got "
            f"{sorted(str(t.device) for t in tensors)}")
    return False


def require_contiguous(name: str, **tensors: torch.Tensor) -> None:
    for k, t in tensors.items():
        require(t.is_contiguous(), name, f"{k} must be contiguous")
