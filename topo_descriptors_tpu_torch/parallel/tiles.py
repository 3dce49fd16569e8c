"""Out-of-core banded execution on one device: grids larger than device
memory (and, with a window reader, larger than host memory) streamed
through the card in halo-overlapped row bands.

Counterpart of ``topo_descriptors_tpu/parallel/tiles.py``:

* the host array or window reader is cut into row bands of ``tile_rows``;
* each band goes to the device with a halo of the op's influence radius
  (disk 'same' anchor, Gaussian tap radius + 1 for ``np.gradient``, Sx ray
  border, rotated-kernel half-extent);
* the op runs on the (band + halo) window with its normal boundary
  handling: the window's synthetic edges only reach outputs inside the
  halo, which are cropped, and true global edges coincide with window
  edges;
* global statistics (TPI/STD centring, valley/ridge standardization) come
  from a float64 host pass over the whole field first, so every band sees
  the same constants.

The band loop (:meth:`TiledRunner._drive`) runs three stages on three
threads: read + host-to-device copy, compute + device-to-host copy, and
emit. On CUDA both copies go through pinned host memory on streams of
their own. A window reader is read under one lock (:class:`LockedReader`),
so the prefetch thread and a sink that asks the reader for a band's NaN
mask never interleave on its file handle.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from topo_descriptors_tpu_torch import ops
from topo_descriptors_tpu_torch.device import resolve_device
from topo_descriptors_tpu_torch.kernels.gaussian import gaussian_radius
from topo_descriptors_tpu_torch.kernels.valley import rotated_extent
from topo_descriptors_tpu_torch.ops.valley_ridge import bank_fits, device_valley_bank

logger = logging.getLogger(__name__)


class _Cancelled(Exception):
    """Pipeline-teardown signal; never escapes :meth:`TiledRunner._drive`."""


def _malloc_trim():
    """Return freed band buffers to the OS after a banded run.

    Each band cycles hundreds of MB of short-lived host buffers; glibc keeps
    those arenas, so successive descriptor families would each add a band
    set to the peak RSS. Best effort: a no-op off glibc."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


class LockedReader:
    """A window reader whose reads hold one lock.

    ``GeoTiffWindowReader`` seeks and reads on one shared file object, so two
    threads reading at once (the band prefetch, and a sink asking for the
    band's pre-fill NaN mask) interleave their seeks: wrong pixels without a
    word on uncompressed strips, a zlib error on deflate strips. Every read
    here (``reader[...]``, ``read_rows``, ``nan_rows``) takes the lock; other
    attributes pass through. :meth:`wrap` is idempotent, so a runner and the
    sinks given the same wrapped reader share one lock.

    The last ``nan_rows`` mask is kept (read-only): every output of a band
    asks for the same rows, and each ask is a decode of the band otherwise.
    """

    def __init__(self, reader):
        self.reader = reader
        self._lock = threading.Lock()
        self._mask_rows: Optional[Tuple[int, int]] = None
        self._mask: Optional[np.ndarray] = None

    @classmethod
    def wrap(cls, reader) -> "LockedReader":
        return reader if isinstance(reader, cls) else cls(reader)

    def __getattr__(self, name):
        return getattr(self.reader, name)

    def __getitem__(self, key) -> np.ndarray:
        with self._lock:
            return self.reader[key]

    def read_rows(self, *args) -> np.ndarray:
        with self._lock:
            return self.reader.read_rows(*args)

    def nan_rows(self, r0: int, r1: int) -> np.ndarray:
        with self._lock:
            if self._mask_rows != (r0, r1):
                self._mask = self.reader.nan_rows(r0, r1)
                self._mask.flags.writeable = False
                self._mask_rows = (r0, r1)
            return self._mask

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.reader.close()


class _Transfers:
    """The host/device copies of one banded run.

    On CUDA a window is staged in pinned memory and copied with
    ``non_blocking=True`` on the ``h2d`` stream; the compute stream waits
    for its event and records itself on the window, so the caching
    allocator does not hand the window's memory out again before the
    compute that reads it has run. Results are copied into fresh pinned
    host tensors on the ``d2h`` stream, and :meth:`fetch` returns only once
    that copy's event has completed: a pinned buffer read before its copy
    lands gives wrong numbers silently. Every band gets buffers of its own
    (no ring is reused), so a band's host arrays are owned by that band and
    writable. On the CPU the copies are plain tensor moves.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def put(self, host: np.ndarray):
        """(window tensor, ready event or None); runs on the prefetch thread."""
        if not self.cuda:
            return torch.from_numpy(np.array(host, dtype=np.float32)), None
        pinned = torch.empty(host.shape, dtype=torch.float32, pin_memory=True)
        pinned.numpy()[...] = host
        with torch.cuda.stream(self.h2d):
            window = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.h2d)
        return window, ready

    def take(self, window: torch.Tensor, ready) -> torch.Tensor:
        """The window, safe to read on the current stream (compute thread)."""
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            window.record_stream(stream)
        return window

    def fetch(self, tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
        """Device tensors -> owned, writable host arrays that have landed."""
        if not self.cuda:
            return [np.array(t.numpy()) for t in tensors]
        tensors = [t.contiguous() for t in tensors]
        self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.d2h):
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for host, t in zip(hosts, tensors):
                host.copy_(t, non_blocking=True)
                t.record_stream(self.d2h)
            landed = torch.cuda.Event()
            landed.record(self.d2h)
        landed.synchronize()
        return [host.numpy() for host in hosts]


def _first(outs):
    return None if outs is None else outs[0]


def _as_sinks(sink):
    return None if sink is None else [sink]


class TiledRunner:
    """Banded out-of-core execution of the descriptor ops on one device.

    ``dem`` may be a host ndarray or a *window reader* (``.shape`` and
    contiguous row slicing, e.g.
    :class:`~topo_descriptors_tpu_torch.io.windowed.DemWindowReader`), in which
    case only one halo-extended band is resident at a time. Every op takes
    an optional ``sink(start_row, band)`` (or a list of them for ops with
    several outputs); bands are then handed over in order as they finish
    instead of being stitched into full outputs in host memory. Outputs
    are host numpy arrays.

    ``device="cuda"`` raises where CUDA is missing (pass ``"cpu"`` for the
    plain PyTorch versions). ``pipeline=False`` runs the bands one after
    another on the calling thread, with the same results bit for bit.
    """

    def __init__(self, tile_rows: int = 4096, pipeline: bool = True, device="cuda"):
        self.tile_rows = int(tile_rows)
        if self.tile_rows < 1:
            raise ValueError(f"tile_rows must be positive, got {tile_rows}")
        self.pipeline = bool(pipeline)
        self.device = resolve_device(device)

    # -- banding machinery -------------------------------------------------
    def _bands(self, n_rows: int, halo_lo: int, halo_hi: int):
        """Yield (band_start, band_stop, win_start, win_stop) row ranges."""
        for start in range(0, n_rows, self.tile_rows):
            stop = min(start + self.tile_rows, n_rows)
            yield start, stop, max(0, start - halo_lo), min(n_rows, stop + halo_hi)

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _drive(self, dem, halo: Tuple[int, int], compute, emit):
        """The band loop every op uses.

        ``compute(window, meta)`` returns the band's outputs as device
        tensors; they are fetched to host arrays and ``emit(meta, bands)``
        receives them in band order. With ``self.pipeline`` (and more than
        one band), band k+1 is read and copied to the device on a prefetch
        thread and band k-1 emitted on a writer thread while band k
        computes and is fetched on the calling thread. The queues hold one
        band each. An error in any stage stops the others (they poll a stop
        event every 0.2 s) and re-raises here, on the caller's thread.
        """
        metas = list(self._bands(dem.shape[0], *halo))
        if not isinstance(dem, np.ndarray):
            dem = LockedReader.wrap(dem)
        moves = _Transfers(self.device)

        def load(meta):
            return moves.put(np.asarray(dem[meta[2] : meta[3]]))

        def run(meta, loaded):
            return moves.fetch(compute(moves.take(*loaded), meta))

        try:
            if not self.pipeline or len(metas) <= 1:
                with self._on_device():
                    for meta in metas:
                        emit(meta, run(meta, load(meta)))
            else:
                self._pipelined(metas, load, run, emit)
        finally:
            _malloc_trim()

    def _pipelined(self, metas, load, run, emit):
        stop_ev = threading.Event()
        errors: list = []

        def _put(q, item):
            while True:
                try:
                    q.put(item, timeout=0.2)
                    return
                except queue.Full:
                    if stop_ev.is_set():
                        raise _Cancelled()

        def _get(q):
            while True:
                try:
                    return q.get(timeout=0.2)
                except queue.Empty:
                    if stop_ev.is_set():
                        raise _Cancelled()

        def stage(body):
            def target():
                try:
                    with self._on_device():
                        body()
                except _Cancelled:
                    pass
                except BaseException as exc:  # re-raised on the caller's thread
                    errors.append(exc)
                    stop_ev.set()

            return target

        in_q: queue.Queue = queue.Queue(maxsize=1)
        out_q: queue.Queue = queue.Queue(maxsize=1)

        def producer():
            for meta in metas:
                _put(in_q, (meta, load(meta)))
            _put(in_q, None)

        def writer():
            while (item := _get(out_q)) is not None:
                emit(*item)

        def main():
            while (item := _get(in_q)) is not None:
                meta, loaded = item
                _put(out_q, (meta, run(meta, loaded)))
            _put(out_q, None)

        threads = [threading.Thread(target=stage(producer), daemon=True, name="tiles-prefetch"),
                   threading.Thread(target=stage(writer), daemon=True, name="tiles-write")]
        for t in threads:
            t.start()
        stage(main)()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def _run(self, dem, halo: Tuple[int, int], fn, sinks=None, post=None):
        """Apply ``fn(window, rows, meta)`` to every band; it returns a list
        of device tensors holding the band's rows (``rows`` selects them in
        the window; any leading dims). ``post(band, start)`` edits each
        fetched host band in place. The i-th output is stitched into a full
        host array, or handed to ``sinks[i](start, band)``; returns the list
        of stitched arrays, or None with sinks."""
        n_rows = dem.shape[0]
        outs: list = []

        def compute(window, meta):
            start, stop, win_lo, _ = meta
            return fn(window, slice(start - win_lo, stop - win_lo), meta)

        def emit(meta, bands):
            start, stop = meta[0], meta[1]
            if post is not None:
                for band in bands:
                    post(band, start)
            if sinks is not None:
                for sink, band in zip(sinks, bands):
                    sink(start, band)
                return
            if not outs:
                outs.extend(np.empty(b.shape[:-2] + (n_rows, b.shape[-1]), b.dtype)
                            for b in bands)
            for out, band in zip(outs, bands):
                out[..., start:stop, :] = band

        self._drive(dem, halo, compute, emit)
        return None if sinks is not None else outs

    # -- global statistics on the host ----------------------------------------
    def _center(self, dem) -> float:
        """round(nanmean) of the whole field (the TPI/STD centring constant),
        in float64: one pass for an ndarray, band-wise partial sums for a
        window reader."""
        if isinstance(dem, np.ndarray):
            return float(np.round(np.nanmean(dem, dtype=np.float64)))
        total, count = 0.0, 0
        n_rows = dem.shape[0]
        for start in range(0, n_rows, self.tile_rows):
            block = np.asarray(dem[start : min(start + self.tile_rows, n_rows)])
            total += float(np.nansum(block, dtype=np.float64))
            count += int(np.count_nonzero(~np.isnan(block)))
        return float(np.round(total / count))

    def _field_stats(self, dem, sigma) -> Tuple[float, float]:
        """float64 (mean, std) of the optionally smoothed field, smoothed on
        the host with scipy (the reference standardizes the smoothed DEM).
        A window reader is smoothed band-wise with a halo of the Gaussian
        tap radius, so its rows match the whole-field filter; its sums are
        shifted by the first value to keep the one-pass variance
        well-conditioned."""
        from scipy import ndimage

        if isinstance(dem, np.ndarray):
            field = dem
            if sigma:
                field = ndimage.gaussian_filter(dem.astype(np.float32), sigma)
            mean = float(np.mean(field, dtype=np.float64))
            var = float(np.mean((field.astype(np.float64) - mean) ** 2))
            return mean, float(np.sqrt(var))
        r = gaussian_radius(sigma) if sigma else 0
        s = s2 = 0.0
        n = 0
        shift = None
        for start, stop, win_lo, win_hi in self._bands(dem.shape[0], r, r):
            window = np.asarray(dem[win_lo:win_hi]).astype(np.float32)
            if sigma:
                window = ndimage.gaussian_filter(window, sigma)
            rows = window[start - win_lo : stop - win_lo].astype(np.float64)
            if shift is None:
                shift = float(rows.flat[0])
            rows -= shift
            s += float(rows.sum())
            s2 += float((rows * rows).sum())
            n += rows.size
        mean_c = s / n
        var = max(s2 / n - mean_c * mean_c, 0.0)
        return mean_c + shift, float(np.sqrt(var))

    @staticmethod
    def _zero_global_border(band, start, n_rows, b):
        """The global-frame zero border of Sx on one band, in place: rows by
        their global index, the left and right columns always."""
        h = band.shape[-2]
        lo = min(max(b - start, 0), h)
        band[..., :lo, :] = 0.0
        hi = min(max(start + h - (n_rows - b), 0), h)
        if hi:
            band[..., h - hi :, :] = 0.0
        band[..., :, :b] = 0.0
        band[..., :, band.shape[-1] - b :] = 0.0
        return band

    # -- descriptors -------------------------------------------------------
    def gaussian(self, dem, sigma, truncate: float = 4.0, sink=None):
        """Banded scipy-parity Gaussian (the smoothed-DEM descriptor)."""
        sig_y = sigma if np.isscalar(sigma) else sigma[0]
        r = gaussian_radius(sig_y, truncate) if sig_y else 0

        def fn(window, rows, meta):
            return [ops.gaussian_filter(window, sigma, truncate)[rows]]

        return _first(self._run(dem, (r, r), fn, _as_sinks(sink)))

    def tpi(self, dem, size: int, sigma: Optional[float] = None, sink=None):
        """Banded TPI with the global centring constant."""
        halo = size // 2 + (gaussian_radius(sigma) if sigma else 0)
        center = self._center(dem)

        def fn(window, rows, meta):
            return [ops.tpi(window, size, sigma, center=center, device=window.device)[rows]]

        return _first(self._run(dem, (halo, halo), fn, _as_sinks(sink)))

    def std(self, dem, size: int, sigma: Optional[float] = None, sink=None):
        """Banded rolling STD with the global centring constant."""
        halo = size // 2 + (gaussian_radius(sigma) if sigma else 0)
        center = self._center(dem)

        def fn(window, rows, meta):
            return [ops.std(window, size, sigma, center=center, device=window.device)[rows]]

        return _first(self._run(dem, (halo, halo), fn, _as_sinks(sink)))

    def disk_descriptors(
        self,
        dem,
        sizes: Sequence[int],
        sigma: Optional[float] = None,
        compute_tpi: bool = True,
        compute_std: bool = True,
        sinks: Optional[Dict[str, List]] = None,
    ) -> Optional[Dict[str, np.ndarray]]:
        """Banded fused multi-scale TPI/STD (:func:`ops.disk_descriptors`):
        each band's window, with the largest scale's halo, goes to the device
        once for every (descriptor, scale) output.

        ``sinks`` maps kind -> one ``sink(start, band)`` per scale. Without
        sinks, returns ``{"tpi": (S, H, W), "std": ...}``."""
        sizes = [int(s) for s in sizes]
        halo = max(sizes) // 2 + (gaussian_radius(sigma) if sigma else 0)
        center = self._center(dem)
        kinds = [k for k, on in (("tpi", compute_tpi), ("std", compute_std)) if on]

        def fn(window, rows, meta):
            batch = ops.disk_descriptors(window, sizes, sigma, compute_tpi=compute_tpi,
                                         compute_std=compute_std, center=center,
                                         device=window.device)
            return [batch[k][:, rows] for k in kinds]

        def per_scale(kind_sinks):
            def sink(start, band):
                for s_idx, scale_sink in enumerate(kind_sinks):
                    scale_sink(start, band[s_idx])

            return sink

        stacked = None if sinks is None else [per_scale(sinks[k]) for k in kinds]
        outs = self._run(dem, (halo, halo), fn, stacked)
        return None if outs is None else dict(zip(kinds, outs))

    def gradient(
        self,
        dem,
        sigma: float,
        res_meters: Dict[str, np.ndarray],
        sig_ratio: float = 1.0,
        sinks=None,
    ) -> Optional[List[np.ndarray]]:
        """Banded gradient/slope/aspect: ``[dx, dy, slope, aspect]``, all
        four from one device call per band (or to the four ``sinks``). 2-D
        resolution planes (geographic grids) are banded with the window."""
        if sigma <= 1:
            halo = 1
        else:
            halo = gaussian_radius(max(sigma, sigma * sig_ratio)) + 1
        x_res = np.asarray(res_meters["x"])
        y_res = np.asarray(res_meters["y"])

        def fn(window, rows, meta):
            win_lo, win_hi = meta[2], meta[3]
            res = {"x": x_res if x_res.ndim == 1 else x_res[win_lo:win_hi],
                   "y": y_res[win_lo:win_hi]}
            outs = ops.gradient(window, sigma, res, sig_ratio, device=window.device)
            return [out[rows] for out in outs]

        return self._run(dem, (halo, halo), fn, sinks)

    def valley_ridge(
        self,
        dem,
        size: int,
        mode: str,
        flat_list: Sequence[float] = (0, 0.15, 0.3),
        sigma: Optional[float] = None,
        sinks=None,
    ) -> Optional[List[np.ndarray]]:
        """Banded valley/ridge: ``[norm, direction]``, both from one device
        call per band (or to the two ``sinks``). The standardization uses
        the global float64 :meth:`_field_stats` of the (smoothed) field.

        Within ``CFG.valley_bank_max_bytes`` the rotated bank is built once
        on the device (:func:`~..ops.valley_ridge.device_valley_bank`) and
        every band convolves it; above it each band runs the streamed
        on-device rotation (:func:`ops.valley_ridge` routes a bank-less call
        there). The bank is passed rather than left to the op's device
        cache: band windows of different heights get different angle
        chunks, hence different cache keys, and would rebuild it."""
        if mode not in ("valley", "ridge"):
            raise ValueError(f"Unknown mode {mode!r}")
        ky, _ = rotated_extent(size)
        halo = ky // 2 + 1 + (gaussian_radius(sigma) if sigma else 0)
        bank = None
        if bank_fits(size, len(flat_list)):
            bank = device_valley_bank(size, mode, flat_list, self.device)
        stats = self._field_stats(dem, sigma)

        def fn(window, rows, meta):
            outs = ops.valley_ridge(window, size, mode, list(flat_list), sigma, bank=bank,
                                    stats=stats, device=window.device)
            return [out[rows] for out in outs]

        return self._run(dem, (halo, halo), fn, sinks)

    def sx(
        self,
        dem,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        sink=None,
    ) -> Optional[np.ndarray]:
        """Banded Sx. The zero border belongs to the global frame, so each
        window runs without it and each band gets it at global
        coordinates."""
        b, n_rows = int(border), dem.shape[0]

        def fn(window, rows, meta):
            return [ops.sx(window, offsets, distances, border, height, zero_border=False,
                           device=window.device)[rows]]

        def post(band, start):
            self._zero_global_border(band, start, n_rows, b)

        return _first(self._run(dem, (b, b), fn, _as_sinks(sink), post))

    def sx_sweep(
        self,
        dem,
        offsets: np.ndarray,
        distances: np.ndarray,
        border: int,
        height: float = 10.0,
        sink=None,
    ) -> Optional[np.ndarray]:
        """Banded Sx azimuth sweep -> (A, H, W): each band's window goes to
        the device once for the whole fan. ``sink(start, band)`` receives
        (A, rows, W) bands, with the zero border of the global frame."""
        b, n_rows = int(border), dem.shape[0]

        def fn(window, rows, meta):
            return [ops.sx_sweep(window, offsets, distances, border, height, zero_border=False,
                                 device=window.device)[:, rows]]

        def post(band, start):
            self._zero_global_border(band, start, n_rows, b)

        return _first(self._run(dem, (b, b), fn, _as_sinks(sink), post))
