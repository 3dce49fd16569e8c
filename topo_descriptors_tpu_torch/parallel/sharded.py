"""Sharded descriptor ops: each op on every block of a mesh, with its halo.

Counterpart of ``topo_descriptors_tpu/parallel/sharded.py``. Every method
of :class:`ShardedOps` computes a whole descriptor of a DEM blocked over a
:class:`~.mesh.Mesh`, equal to the single-pass op on the valid interior:

* convolution halos sized by the kernel's 'same' anchor ((k-1-s, s) per
  axis), exchanged with zero fill, then a VALID convolution of each
  halo-extended block (:func:`~..ops.conv.conv2d_valid`, which takes a
  {0,1} disk to the ``disk_sat`` kernel on a CUDA block);
* Gaussian halos of the tap radius with reflect fill at true edges;
* ``np.gradient`` edges through the linear-extrapolation fill;
* global statistics (the TPI/STD centring constant, the valley/ridge
  standardization) from float32 block sums, added in row-major block order
  on the first block's device (``all_reduce`` of the per-block vector
  across processes), so a run is deterministic;
* Sx: a ray-border halo with NaN fill (multi-hop where rays span blocks),
  :func:`~..ops.sx` / :func:`~..ops.sx_sweep` on the extended block, which
  runs ``sx_block`` / ``sx_fan`` on a CUDA block, the block cropped out and
  the zero border set in the global frame.

Global shapes must divide the mesh. A ragged grid is padded bottom/right
with ``mesh.pad_to_mesh`` and passes ``valid_shape`` (the original shape):
reflections then happen at the true edge, statistics and tap counts come
from the true domain, and pad pixels weigh as the single pass's boundary.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.device import TableCache, upload
from topo_descriptors_tpu_torch.kernels.disk import Disk
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_kernel1d, gaussian_radius
from topo_descriptors_tpu_torch.kernels.sobel import sobel_kernel
from topo_descriptors_tpu_torch.kernels.valley import rotated_extent
from topo_descriptors_tpu_torch.ops import conv as C
from topo_descriptors_tpu_torch.ops.dft_conv import conv_bank, field_spectrum, get_plan
from topo_descriptors_tpu_torch.ops.valley_ridge import (
    _flat_axis_combine,
    _scan_chunks,
    _streamed_scan,
    bank_fits,
    device_valley_bank,
    quadrant_canvases,
    streamed_schedule,
)
from topo_descriptors_tpu_torch.parallel.halo import (
    _reflect_oob,
    exchange_halo,
    global_index,
    halo_pad_1d,
)
from topo_descriptors_tpu_torch.parallel.mesh import Block, Mesh, ShardedArray, shard_raster

Blocks = Dict[Block, torch.Tensor]
VALLEY_ANGLE_CHUNK = 30  # angles per row-channel convolution, as ops.valley_ridge


class ShardedOps:
    """The descriptor suite over a 2-D mesh.

    Construct once per mesh. Methods take and return
    :class:`~.mesh.ShardedArray` s and run on this process's blocks; the
    device state of a signature (tap-count planes, rotated banks) stays in
    a cache of 16 entries.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.gy, self.gx = mesh.shape
        self._cache = TableCache(16)

    # -- placement and checks -------------------------------------------------
    def _check(self, x: ShardedArray) -> None:
        if not isinstance(x, ShardedArray):
            raise TypeError(f"expected a ShardedArray (ShardedOps.put), got {type(x).__name__}")
        if x.mesh.entries != self.mesh.entries or x.mesh.shape != self.mesh.shape:
            raise ValueError(f"the array lives on {x.mesh}, these ops on {self.mesh}")

    def put(self, array) -> ShardedArray:
        """Place a global host array onto the mesh, blocked (gy, gx)."""
        return shard_raster(self.mesh, array)

    def _wrap(self, shape, blocks: Blocks) -> ShardedArray:
        return ShardedArray(self.mesh, shape, blocks)

    # -- block geometry and global statistics ------------------------------------
    def _valid_mask(self, b: Block, block_shape, valid_shape, device) -> torch.Tensor:
        """0/1 float mask of the true domain on block ``b``."""
        lh, lw = block_shape
        giy = global_index(b[0], lh, device)
        gix = global_index(b[1], lw, device)
        vh, vw = valid_shape
        return ((giy < vh)[:, None] & (gix < vw)[None, :]).to(torch.float32)

    def _masks(self, blocks: Blocks, valid_shape) -> Optional[Blocks]:
        if valid_shape is None:
            return None
        return {b: self._valid_mask(b, t.shape[-2:], valid_shape, t.device)
                for b, t in blocks.items()}

    def _global_sum(self, parts: Blocks) -> torch.Tensor:
        """Sum over the mesh of the blocks' float32 sums, added in row-major
        block order on the first local block's device. In a process group
        each rank fills its blocks' slots of a per-block vector, zero
        elsewhere, and an ``all_reduce`` adds the vectors exactly (under
        gloo through host memory); every rank then adds the slots in the
        same order."""
        local = self.mesh.local_blocks()
        dev = parts[local[0]].device
        if not self.mesh.grouped:
            sums = [parts[b].sum().to(dev) for b in local]
        else:
            vec = torch.zeros(self.gy * self.gx, dtype=torch.float32, device=dev)
            for b in local:
                vec[b[0] * self.gx + b[1]] = parts[b].sum().to(dev)
            if dist.get_backend() == "gloo" and dev.type != "cpu":
                host = vec.cpu()
                dist.all_reduce(host)
                vec = host.to(dev)
            else:
                dist.all_reduce(vec)
            sums = list(vec)
        total = sums[0]
        for s in sums[1:]:
            total = total + s
        return total

    def _stats_count(self, blocks: Blocks, valid_shape) -> float:
        h = self.gy * next(iter(blocks.values())).shape[-2]
        w = self.gx * next(iter(blocks.values())).shape[-1]
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        return float(vh * vw)

    def _center(self, blocks: Blocks, masks: Optional[Blocks], count: float) -> torch.Tensor:
        """round(mean) over the true domain: the TPI/STD centring constant
        (the rounding absorbs summation-order differences)."""
        parts = blocks if masks is None else {b: t * masks[b] for b, t in blocks.items()}
        return torch.round(self._global_sum(parts) / count)

    def _standardize(self, blocks: Blocks, valid_shape) -> Blocks:
        """(block - mean) / std over the true domain (population std); pad
        pixels are zeroed after, so they weigh as the single pass's zero
        boundary."""
        masks = self._masks(blocks, valid_shape)
        count = self._stats_count(blocks, valid_shape)

        def masked(parts):
            return parts if masks is None else {b: t * masks[b] for b, t in parts.items()}

        mean = self._global_sum(masked(blocks)) / count
        dev = {b: mean.to(t.device) for b, t in blocks.items()}
        var = self._global_sum(masked({b: (t - dev[b]) ** 2 for b, t in blocks.items()})) / count
        std = torch.sqrt(var)
        out = {b: (t - dev[b]) / std.to(t.device) for b, t in blocks.items()}
        return masked(out)

    def _counts(self, shape, valid_shape, kernel: Disk) -> Blocks:
        """Each block's slice of the exact boundary tap-count plane of the
        true grid, zero past it, built per block on its device."""
        h, w = shape[-2:]
        lh, lw = h // self.gy, w // self.gx
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        key = ("counts", (h, w), (vh, vw), kernel)

        def build():
            out = {}
            for i, j in self.mesh.local_blocks():
                dev = self.mesh.device((i, j))
                r0, r1 = min(i * lh, vh), min((i + 1) * lh, vh)
                c0, c1 = min(j * lw, vw), min((j + 1) * lw, vw)
                plane = C.edge_count_plane_device((vh, vw), kernel, dev, ((r0, r1), (c0, c1)))
                if plane.shape != (lh, lw):
                    plane = torch.nn.functional.pad(
                        plane, (0, lw - plane.shape[1], 0, lh - plane.shape[0]))
                out[(i, j)] = plane
            return out

        return self._cache.get(key, build)

    # -- Gaussian ----------------------------------------------------------------
    def _gaussian_blocks(self, blocks: Blocks, sigma, truncate: float = 4.0,
                         valid=None) -> Blocks:
        """Per-axis separable Gaussian: exchange the tap radius with reflect
        fill at the true edge, then a VALID correlation; equal to
        ``scipy.ndimage.gaussian_filter`` of the global field.

        ``valid`` (vh, vw) serves grids padded bottom/right: the pad
        positions and the halo beyond them are overwritten with reflections
        of in-domain data before correlating, so the valid outputs equal the
        unpadded filter. The pad must fit beside its reflection in one
        block (pad <= block / 2)."""
        sigmas = (sigma, sigma) if np.isscalar(sigma) else tuple(sigma)
        for axis, s in enumerate(sigmas):
            if not s or s <= 0:
                continue
            taps = gaussian_kernel1d(s, truncate).astype(np.float32)
            r = gaussian_radius(s, truncate)
            n = next(iter(blocks.values())).shape[axis]
            total = self.mesh.shape[axis] * n
            v = valid[axis] if valid is not None else total
            if v == total:
                blocks = halo_pad_1d(blocks, self.mesh, axis, (r, r), "reflect")
            else:
                if 2 * (total - v) > n:
                    raise ValueError(
                        f"ragged pad {total - v} too wide for block {n} along "
                        f"{('gy', 'gx')[axis]}: the true-edge reflection source must fit in "
                        "the same block")
                if r > 2 * v - total:  # needs a second reflection, which ext cannot give
                    raise ValueError(
                        f"reflect halo {(r, r)} too wide for mesh axis {('gy', 'gx')[axis]} "
                        f"(domain {v} padded to {total}): use fewer devices along this axis "
                        "or the tiled runner")
                ext = halo_pad_1d(blocks, self.mesh, axis, (r, r), "zero")
                blocks = {b: _reflect_oob(t, axis, r, b[axis], n, v) for b, t in ext.items()}
            blocks = {b: C._correlate1d_valid(t, taps, axis) for b, t in blocks.items()}
        return blocks

    def gaussian(self, x: ShardedArray, sigma, truncate: float = 4.0,
                 valid_shape: Optional[Tuple[int, int]] = None) -> ShardedArray:
        """Sharded scipy-parity Gaussian smoothing (the smoothed-DEM
        descriptor). ``valid_shape`` reflects at the true edge of a ragged
        padded grid."""
        self._check(x)
        return self._wrap(x.shape, self._gaussian_blocks(x.blocks, sigma, truncate, valid_shape))

    # -- the disk family ------------------------------------------------------------
    def _disk_prologue(self, x: ShardedArray, sigma, valid_shape):
        """(smoothed blocks, masks, centring constant) of TPI and STD."""
        self._check(x)
        blocks = x.blocks
        if sigma:
            blocks = self._gaussian_blocks(blocks, sigma, valid=valid_shape)
        masks = self._masks(blocks, valid_shape)
        c = self._center(blocks, masks, self._stats_count(blocks, valid_shape))
        return blocks, masks, c

    @staticmethod
    def _pads(kernel: Disk):
        return C._same_pads(kernel.shape[0]), C._same_pads(kernel.shape[1])

    def tpi(self, x: ShardedArray, size: int, sigma: Optional[float] = None,
            valid_shape: Optional[Tuple[int, int]] = None) -> ShardedArray:
        """Sharded TPI. ``valid_shape`` serves ragged padded grids: the
        pre-smooth reflects at the true edge, the centring constant and the
        tap counts come from the true domain, and pad pixels are zeroed in
        the centred field, so they weigh as the single pass's zero
        boundary."""
        kernel = Disk(size, exclude_center=True)
        ksum = float(kernel.taps)
        blocks, masks, c = self._disk_prologue(x, sigma, valid_shape)
        counts = self._counts(x.shape, valid_shape, kernel)
        z = {b: t - c.to(t.device) for b, t in blocks.items()}
        if masks is not None:
            z = {b: t * masks[b] for b, t in z.items()}
        (ply, phy), (plx, phx) = self._pads(kernel)
        zp = exchange_halo(z, self.mesh, (ply, phy), (plx, phx), "zero")
        out = {}
        for b, t in blocks.items():
            conv = C.conv2d_valid(zp[b][None], kernel)[0]
            out[b] = t - (conv + c.to(t.device) * counts[b]) / ksum
        return self._wrap(x.shape, out)

    def std(self, x: ShardedArray, size: int, sigma: Optional[float] = None,
            int32_parity: bool = True,
            valid_shape: Optional[Tuple[int, int]] = None) -> ShardedArray:
        """Sharded rolling STD, with the mean-centred float32-stable form of
        :func:`ops.std`; ``valid_shape`` as in :meth:`tpi`."""
        kernel = Disk(size)
        ksum = float(kernel.taps)
        blocks, masks, c = self._disk_prologue(x, sigma, valid_shape)
        counts = self._counts(x.shape, valid_shape, kernel)
        stacks = {}
        for b, t in blocks.items():
            cb = c.to(t.device)
            tt = torch.trunc(t) if int32_parity else t
            t_c, z_c = tt - cb, t - cb
            if masks is not None:
                t_c, z_c = t_c * masks[b], z_c * masks[b]
            stacks[b] = torch.stack([t_c * t_c, t_c, z_c])
        (ply, phy), (plx, phx) = self._pads(kernel)
        ext = exchange_halo(stacks, self.mesh, (ply, phy), (plx, phx), "zero")
        out = {}
        for b, t in blocks.items():
            cb = c.to(t.device)
            q, tt, z = C.conv2d_valid(ext[b], kernel)
            sum_sq = q + 2.0 * cb * tt + cb * cb * counts[b]
            sum_dem = z + cb * counts[b]
            var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
            out[b] = torch.sqrt(torch.clamp(var, min=0.0))
        return self._wrap(x.shape, out)

    def disk_descriptors(
        self,
        x: ShardedArray,
        sizes: Sequence[int],
        sigma: Optional[float] = None,
        compute_tpi: bool = True,
        compute_std: bool = True,
        int32_parity: bool = True,
        valid_shape: Optional[Tuple[int, int]] = None,
    ) -> Dict[str, ShardedArray]:
        """Fused multi-scale TPI/STD over the mesh, the sharded counterpart
        of :func:`ops.disk_descriptors`: the centred moment fields are built
        once, the halo is exchanged once at the largest scale's width (each
        smaller scale convolves a centred crop of the same extended stack),
        and TPI rides STD's intermediates. Returns ``{"tpi": (S, H, W),
        "std": (S, H, W)}``."""
        sizes = [int(s) for s in sizes]
        disks = [Disk(s) for s in sizes]
        ksums = [float(k.taps) for k in disks]
        pads = [self._pads(k) for k in disks]
        ply_m, phy_m = max(p[0][0] for p in pads), max(p[0][1] for p in pads)
        plx_m, phx_m = max(p[1][0] for p in pads), max(p[1][1] for p in pads)
        blocks, masks, c = self._disk_prologue(x, sigma, valid_shape)
        counts = [self._counts(x.shape, valid_shape, k) for k in disks]
        fields, z_cs = {}, {}
        for b, t in blocks.items():
            cb = c.to(t.device)
            z_c = t - cb
            if masks is not None:
                z_c = z_c * masks[b]
            z_cs[b] = z_c
            if compute_std:
                t_c = (torch.trunc(t) if int32_parity else t) - cb
                if masks is not None:
                    t_c = t_c * masks[b]
                fields[b] = torch.stack([z_c, t_c, t_c * t_c])
            else:
                fields[b] = z_c[None]
        ext = exchange_halo(fields, self.mesh, (ply_m, phy_m), (plx_m, phx_m), "zero")
        out_tpi, out_std = {}, {}
        for b, t in blocks.items():
            cb = c.to(t.device)
            e = ext[b]
            tpis, stds = [], []
            for i, (disk, ksum) in enumerate(zip(disks, ksums)):
                (ply, phy), (plx, phx) = pads[i]
                trimmed = e[:, ply_m - ply : e.shape[1] - (phy_m - phy),
                            plx_m - plx : e.shape[2] - (phx_m - phx)]
                convs = C.conv2d_valid(trimmed.contiguous(), disk)  # the kernel reads rows whole
                n = counts[i][b]
                if compute_tpi:  # centre-zeroed disk = full disk minus the centre tap
                    tpi_sum = (convs[0] - z_cs[b]) + cb * (n - 1.0)
                    tpis.append(t - tpi_sum / (ksum - 1.0))
                if compute_std:
                    sum_sq = convs[2] + 2.0 * cb * convs[1] + cb * cb * n
                    sum_dem = convs[0] + cb * n
                    var = (sum_sq - sum_dem * sum_dem / ksum) / (ksum - 1.0)
                    stds.append(torch.sqrt(torch.clamp(var, min=0.0)))
            if compute_tpi:
                out_tpi[b] = torch.stack(tpis)
            if compute_std:
                out_std[b] = torch.stack(stds)
        shape = (len(sizes),) + tuple(x.shape)
        out = {}
        if compute_tpi:
            out["tpi"] = self._wrap(shape, out_tpi)
        if compute_std:
            out["std"] = self._wrap(shape, out_std)
        return out

    # -- gradient ---------------------------------------------------------------------
    def _central_diff(self, blocks: Blocks, axis: int, valid_len=None) -> Blocks:
        """``np.gradient`` along ``axis``: a one-row halo with linear
        extrapolation makes the central difference give the one-sided edge
        formula. On a ragged grid the last valid row or column takes the
        backward difference, ``np.gradient``'s formula at the true edge."""
        ext = halo_pad_1d(blocks, self.mesh, axis, (1, 1), "linear_extrap")
        out = {}
        for b, t in blocks.items():
            e = ext[b]
            n = e.shape[axis]
            grad = (e.narrow(axis, 2, n - 2) - e.narrow(axis, 0, n - 2)) * 0.5
            total = self.mesh.shape[axis] * t.shape[axis]
            if valid_len is not None and valid_len < total:
                backward = e.narrow(axis, 1, n - 2) - e.narrow(axis, 0, n - 2)
                gi = global_index(b[axis], t.shape[axis], t.device)
                gi = gi[:, None] if axis == 0 else gi[None, :]
                grad = torch.where(gi == valid_len - 1, backward, grad)
            out[b] = grad
        return out

    def _res_blocks(self, res, shape, valid_shape, per_row: bool) -> Blocks:
        """Each block's slice of a metric resolution: a 1-D array per
        column (``x``) or per row (``y``), or a 2-D plane (geographic
        grids), edge-repeated into the pad region of a ragged grid."""
        h, w = shape
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        a = np.asarray(res, dtype=np.float32)
        if a.ndim < 2:
            a = a.reshape(-1, 1) if per_row else a.reshape(1, -1)
        a = np.pad(a, ((0, h - vh if a.shape[0] > 1 else 0), (0, w - vw if a.shape[1] > 1 else 0)),
                   mode="edge")
        lh, lw = h // self.gy, w // self.gx
        out = {}
        for i, j in self.mesh.local_blocks():
            rows = slice(i * lh, (i + 1) * lh) if a.shape[0] > 1 else slice(None)
            cols = slice(j * lw, (j + 1) * lw) if a.shape[1] > 1 else slice(None)
            out[(i, j)] = upload(np.ascontiguousarray(a[rows, cols]), self.mesh.device((i, j)))
        return out

    def gradient(self, x: ShardedArray, sigma: float, res_meters, sig_ratio: float = 1.0,
                 valid_shape: Optional[Tuple[int, int]] = None):
        """Sharded W-E/S-N derivatives, slope and aspect: ``[dx, dy, slope,
        aspect]``. ``res_meters`` is ``scale_to_pixel``'s dict (1-D per
        axis for projected grids, 2-D planes for geographic ones).
        ``valid_shape`` serves ragged padded grids: the pre-smooth and the
        Sobel reflect at the true edge, and ``np.gradient``'s one-sided
        formula applies at the true bottom and right."""
        self._check(x)
        blocks, v = x.blocks, valid_shape
        if sigma <= 1:
            k = sobel_kernel()
            if v is None:
                ext = exchange_halo(blocks, self.mesh, 1, 1, "reflect")
            else:
                ext = exchange_halo(blocks, self.mesh, 1, 1, "zero")
                lh, lw = x.block_shape
                ext = {b: _reflect_oob(_reflect_oob(t, 0, 1, b[0], lh, v[0]), 1, 1, b[1], lw, v[1])
                       for b, t in ext.items()}
            dx = {b: C.conv2d_valid(t[None], k)[0] for b, t in ext.items()}
            dy = {b: C.conv2d_valid(t[None], k.T)[0] for b, t in ext.items()}
        elif sig_ratio == 1:
            smooth = self._gaussian_blocks(blocks, sigma, valid=v)
            dy = self._central_diff(smooth, 0, v[0] if v else None)
            dx = self._central_diff(smooth, 1, v[1] if v else None)
        else:
            sp = sigma * sig_ratio
            dx = self._central_diff(self._gaussian_blocks(blocks, (sp, sigma), valid=v), 1,
                                    v[1] if v else None)
            dy = self._central_diff(self._gaussian_blocks(blocks, (sigma, sp), valid=v), 0,
                                    v[0] if v else None)
        xres = self._res_blocks(res_meters["x"], x.shape, v, per_row=False)
        yres = self._res_blocks(res_meters["y"], x.shape, v, per_row=True)
        outs = [{}, {}, {}, {}]
        for b in blocks:
            gx_, gy_ = dx[b] / xres[b], dy[b] / yres[b]
            outs[0][b], outs[1][b] = gx_, gy_
            outs[2][b] = torch.rad2deg(torch.atan(torch.sqrt(gx_ * gx_ + gy_ * gy_)))
            outs[3][b] = torch.remainder(180.0 + torch.rad2deg(torch.atan2(gx_, gy_)), 360.0)
        return [self._wrap(x.shape, o) for o in outs]

    # -- valley / ridge ---------------------------------------------------------------
    def _bank_chunks(self, size, mode, flat_list, device) -> torch.Tensor:
        """The (size, mode, flats) rotation bank, rotated on ``device`` once
        (:func:`~..ops.valley_ridge.device_valley_bank`), as (n_chunks,
        chunk * F, KY, KX)."""

        def build():
            bank = device_valley_bank(size, mode, flat_list, device)
            a, f, ky, kx = bank.shape
            chunk = VALLEY_ANGLE_CHUNK
            while a % chunk:
                chunk -= 1
            return bank.reshape(a // chunk, chunk * f, ky, kx)

        sig = (size, mode, tuple(float(f) for f in flat_list))
        return self._cache.get(("bank_chunks",) + sig + (torch.device(device),), build)

    def valley_ridge(self, x: ShardedArray, size: int, mode: str,
                     flat_list: Sequence[float] = (0, 0.15, 0.3), sigma: Optional[float] = None,
                     valid_shape: Optional[Tuple[int, int]] = None):
        """Sharded valley/ridge index, ``[norm, direction]``: the global
        standardization from block sums, one zero-fill halo at the bank's
        'same' anchor, then the row-channel library convolution
        (:func:`~..ops.conv.conv2d_bank_rowchan`, ``padding='valid'``) of
        each extended block, ``VALLEY_ANGLE_CHUNK`` angles at a time, with
        the running strictly-greater max/argmax. A bank past
        ``CFG.valley_bank_max_bytes`` (``bank_fits``) runs
        :meth:`valley_ridge_streamed` instead, as the single-device op
        does. ``valid_shape`` serves ragged grids: masked statistics, pad
        pixels zeroed after standardizing; a pre-smooth reflects at the
        true edge."""
        if not bank_fits(size, len(flat_list)):
            return self.valley_ridge_streamed(x, size, mode, flat_list, sigma, valid_shape)
        self._check(x)
        if mode not in ("valley", "ridge"):
            raise ValueError(f"Unknown mode {mode!r}")
        n_flats = len(flat_list)
        blocks = x.blocks
        if sigma:
            blocks = self._gaussian_blocks(blocks, sigma, valid=valid_shape)
        blocks = self._standardize(blocks, valid_shape)
        lh, lw = x.block_shape
        ky, kx = rotated_extent(size)
        padded = exchange_halo(blocks, self.mesh, C._same_pads(ky), C._same_pads(kx), "zero")
        outs = [{}, {}]
        for b, field in padded.items():
            chunks = self._bank_chunks(size, mode, flat_list, field.device)

            def conv_combined(kernels, field=field):
                convs = C.conv2d_bank_rowchan(field, kernels, padding="valid")
                return _flat_axis_combine(convs.reshape(-1, n_flats, lh, lw), axis=1).amax(dim=1)

            outs[0][b], outs[1][b] = _scan_chunks(chunks, n_flats, (lh, lw), conv_combined)
        return [self._wrap(x.shape, o) for o in outs]

    def valley_ridge_streamed(self, x: ShardedArray, size: int, mode: str,
                              flat_list: Sequence[float] = (0, 0.15, 0.3),
                              sigma: Optional[float] = None,
                              valid_shape: Optional[Tuple[int, int]] = None,
                              n_angles: int = 180):
        """Sharded valley/ridge for banks past the memory budget, the mesh
        counterpart of :func:`ops.valley_ridge_streamed`: the global
        standardization, one (multi-hop) zero-fill halo at the rotated
        extent's 'same' anchor, then per block the quadrant scan of the
        single-device op (on-device spline rotation, flips and rot90s for
        the other quadrants, flats folded into the kernels) over VALID
        partial-DFT matmul convolutions of the extended block: the VALID
        convolution of the extended block is the interior of the global
        'same' convolution. ``valid_shape`` as in :meth:`valley_ridge`."""
        self._check(x)
        if mode not in ("valley", "ridge"):
            raise ValueError(f"Unknown mode {mode!r}")
        n_flats = len(flat_list)
        kmax, qparams, slot_angle, slot_valid, q_batch = streamed_schedule(size, n_angles)
        lh, lw = x.block_shape
        (ply, phy) = C._same_pads(kmax)
        eh, ew = lh + ply + phy, lw + ply + phy
        blocks = x.blocks
        if sigma:
            blocks = self._gaussian_blocks(blocks, sigma, valid=valid_shape)
        blocks = self._standardize(blocks, valid_shape)
        padded = exchange_halo(blocks, self.mesh, (ply, phy), (ply, phy), "zero")
        outs = [{}, {}]
        for b, field in padded.items():
            plan = get_plan(eh, ew, kmax, kmax, "valid", field.device)
            if plan.oshape != (lh, lw):
                raise RuntimeError(f"VALID plan gives {plan.oshape}, expected the block {(lh, lw)}")
            fdr, fdi = field_spectrum(field, plan)
            canvas_of = quadrant_canvases(size, mode, list(flat_list), n_angles, q_batch, qparams,
                                          kmax, field.device)
            norm, direction = _streamed_scan(
                canvas_of, lambda k: conv_bank(k, fdr, fdi, plan), qparams, slot_angle,
                slot_valid, q_batch, n_flats, (lh, lw), field.device)
            outs[0][b], outs[1][b] = torch.clamp(norm, min=0.0), direction
        return [self._wrap(x.shape, o) for o in outs]

    # -- Sx -----------------------------------------------------------------------------
    def _sx_blocks(self, x: ShardedArray, border: int, valid_shape, run: Callable) -> Blocks:
        """Exchange a ``border``-wide NaN halo, ``run(extended block)`` (no
        zero border), crop the block out and zero the border in the global
        frame: the original frame's on a ragged grid. The kernels read past
        the extended block as NaN, as the single pass reads past the grid,
        so every plane is the single pass's, bit for bit."""
        self._check(x)
        b_ = int(border)
        h, w = x.shape
        vh, vw = valid_shape if valid_shape is not None else (h, w)
        lh, lw = x.block_shape
        ext = exchange_halo(x.blocks, self.mesh, b_, b_, "nan")
        out = {}
        for b, e in ext.items():
            sx = run(e.contiguous())[..., b_ : b_ + lh, b_ : b_ + lw]
            giy = global_index(b[0], lh, e.device)
            gix = global_index(b[1], lw, e.device)
            interior = (((giy >= b_) & (giy < vh - b_))[:, None]
                        & ((gix >= b_) & (gix < vw - b_))[None, :])
            out[b] = torch.where(interior, sx, 0.0)
        return out

    def sx(self, x: ShardedArray, offsets: np.ndarray, distances: np.ndarray, border: int,
           height: float = 10.0,
           valid_shape: Optional[Tuple[int, int]] = None) -> ShardedArray:
        """Sharded Sx horizon scan: the halo is the full ray border, multi-hop
        where rays span several blocks; ``ops.sx`` runs ``sx_block`` on each
        extended CUDA block. ``valid_shape`` serves grids padded with NaN:
        the pads are dropped like the beyond-edge fill, and the zero border
        sits at the original frame."""
        blocks = self._sx_blocks(
            x, border, valid_shape,
            lambda e: ops.sx(e, offsets, distances, border, height, zero_border=False,
                             device=e.device))
        return self._wrap(x.shape, blocks)

    def sx_sweep(self, x: ShardedArray, offsets: np.ndarray, distances: np.ndarray,
                 border: int, height: float = 10.0,
                 valid_shape: Optional[Tuple[int, int]] = None) -> ShardedArray:
        """Sharded Sx for a fan of azimuths -> (A, H, W): the ray halo is
        exchanged once for the whole fan, and ``ops.sx_sweep`` (``sx_fan`` on
        a CUDA block, as ``auto`` picks it) reduces every azimuth over each
        extended block. ``valid_shape`` as in :meth:`sx`."""
        blocks = self._sx_blocks(
            x, border, valid_shape,
            lambda e: ops.sx_sweep(e, offsets, distances, border, height, zero_border=False,
                                   device=e.device))
        return self._wrap((len(offsets),) + tuple(x.shape), blocks)
