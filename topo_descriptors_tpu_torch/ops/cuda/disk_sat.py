"""Disk ({0,1}-kernel) convolution through row prefix sums.

Replaces ``topo_descriptors_tpu/ops/pallas/disk_sat.py::_sat_kernel`` (and
its launcher ``disk_conv_sat_pallas``). The CUDA kernel is
``csrc/disk_sat.cu``; its header says what bounds it on the H100 (bytes:
2 x runs prefix reads per pixel) and what its two-launch design does about
that. :func:`disk_conv_sat_plain` is the same algorithm in plain PyTorch —
the transcription of the XLA twin ``ops/conv.py::_conv2d_sat``.

:func:`disk_conv_sat` routes by the tensor: CPU tensors take the plain
twin, CUDA tensors the kernel, anything else raises. ``LAUNCHES`` counts
the kernel's CUDA calls (one per convolution: a row scan and a run-sum
pass).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from topo_descriptors_tpu_torch.device import on_cuda, upload
from topo_descriptors_tpu_torch.ops.cuda import _build

LAUNCHES = 0

_INT_MAX = 2**31 - 1


def group_runs(runs):
    """``[(a, b, (r0, r1, ...)), ...]``: kernel rows that share the run
    ``[a, b]``, in order of first appearance — the order in which both the
    twin and the kernel sum them."""
    by_cols: dict = {}
    for r, a, bcol in runs:
        by_cols.setdefault((a, bcol), []).append(r)
    return [(a, bcol, tuple(rows)) for (a, bcol), rows in by_cols.items()]


def run_table(runs):
    """``(table, n_groups)``: the run groups as the kernel reads them —
    ``(a, b, first, end)`` per group, then the row indices that
    ``first..end-1`` point into."""
    groups = group_runs(runs)
    head, rows = [], []
    for a, bcol, grows in groups:
        head.append((a, bcol, len(rows), len(rows) + len(grows)))
        rows.extend(grows)
    table = np.concatenate(
        [np.asarray(head, np.int32).reshape(-1), np.asarray(rows, np.int32)]
    )
    return table, len(groups)


def _out_shape(xs, kshape, pads):
    kh, kw = kshape
    (ly, hy), (lx, hx) = pads
    _, h, w = xs.shape
    return h + ly + hy - kh + 1, w + lx + hx - kw + 1


def disk_conv_sat_plain(xs: torch.Tensor, kshape, runs, pads) -> torch.Tensor:
    """Correlation of the (B, H, W) stack with a {0,1} kernel given as the
    row runs of its flipped form, zero boundary; ``pads`` =
    ``((ly, hy), (lx, hx))`` places the 'same' or 'valid' output."""
    (ly, hy), (lx, hx) = pads
    b = xs.shape[0]
    h_out, w_out = _out_shape(xs, kshape, pads)
    # sentinel zero column on the left so P[..., x+a] with a=0 reads 0
    p = torch.cumsum(F.pad(xs, (lx + 1, hx, ly, hy)), dim=2)
    acc = None
    for a, bcol, rows in group_runs(runs):
        rs = None
        for r in rows:
            sl = p[:, r : r + h_out, :]
            rs = sl if rs is None else rs + sl
        term = rs[:, :, bcol + 1 : bcol + 1 + w_out] - rs[:, :, a : a + w_out]
        acc = term if acc is None else acc + term
    if acc is None:
        acc = xs.new_zeros((b, h_out, w_out))
    return acc


def disk_conv_sat(xs: torch.Tensor, kshape, runs, pads) -> torch.Tensor:
    """:func:`disk_conv_sat_plain` on a CPU tensor; the CUDA kernel on a
    CUDA tensor, which must be a contiguous float32 (B, H, W) stack."""
    global LAUNCHES
    if not on_cuda(xs):
        return disk_conv_sat_plain(xs, kshape, runs, pads)
    if xs.dtype != torch.float32 or xs.dim() != 3 or not xs.is_contiguous():
        raise ValueError(
            "disk_conv_sat needs a contiguous float32 (B, H, W) tensor, got "
            f"{xs.dtype} {tuple(xs.shape)} contiguous={xs.is_contiguous()}"
        )
    (ly, hy), (lx, hx) = pads
    b, h, w = xs.shape
    h_out, w_out = _out_shape(xs, kshape, pads)
    hp, wq = h + ly + hy, w + lx + hx + 1
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"kernel {kshape} does not fit the padded field")
    if b * hp > _INT_MAX or b > 65535 or max(hp, wq) > _INT_MAX:
        raise ValueError(f"field stack {tuple(xs.shape)} exceeds the launch grid")
    out = torch.empty((b, h_out, w_out), dtype=torch.float32, device=xs.device)
    scratch = torch.empty((b, hp, wq), dtype=torch.float32, device=xs.device)
    table, n_groups = run_table(runs)
    table = upload(table, xs.device)
    lib = _build.library()
    with torch.cuda.device(xs.device):
        err = lib.disk_sat_forward(
            xs.data_ptr(), scratch.data_ptr(), out.data_ptr(), table.data_ptr(),
            n_groups, b, h, w, ly, lx, hp, wq, h_out, w_out,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "disk_sat")
    LAUNCHES += 1
    return out
