"""Minimal self-contained GeoTIFF I/O (pure Python + zlib).

The port's own copy of ``topo_descriptors_tpu/io/geotiff.py``:
the port imports nothing of the JAX package.

The reference ingests DEMs through xarray/rasterio; neither ships in this
image, and the benchmark DEM (`Basodino-30m-DEM.tif`, BASELINE.md) is a
GeoTIFF — so the framework speaks the format directly. Supported subset
(which covers SRTM/USGS-style elevation rasters):

* classic TIFF (little/big endian), single-band grayscale
* strip or tile organization
* uncompressed or Deflate/AdobeDeflate compression, horizontal-differencing
  predictor
* uint8/16/32, int8/16/32, float32/64 samples
* georeferencing via ModelPixelScale + ModelTiepoint and the GeoKey
  directory's EPSG code (geographic 2048 / projected 3072 keys)

Coordinates follow the pixel-centre convention (tie point = upper-left
corner of pixel (0,0), i.e. RasterPixelIsArea), matching what
xarray/rioxarray hand to the reference.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from topo_descriptors_tpu_torch.grid import Raster, RasterGrid

# TIFF tag ids
_W, _H = 256, 257
_BITS, _COMP, _PHOTO = 258, 259, 262
_STRIP_OFFSETS, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 278, 279
_SAMPLE_FORMAT = 339
_TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_PREDICTOR = 317
_SAMPLES_PER_PIXEL = 277
_PIXEL_SCALE, _TIEPOINT, _GEO_KEYS = 33550, 33922, 34735

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_ifd_file(f, bo: str, offset: int) -> Dict[int, tuple]:
    """Parse one IFD from an open file handle with seeks — only the directory
    and out-of-line values are read, never the pixel payload (the windowed
    reader's whole point; compare the round-1 whole-file ``read_bytes``)."""
    f.seek(offset)
    n_entries = struct.unpack(bo + "H", f.read(2))[0]
    directory = f.read(n_entries * 12)
    tags = {}
    deferred = []  # (tag, typ, count, value_offset) for out-of-line values
    for i in range(n_entries):
        tag, typ, count = struct.unpack_from(bo + "HHI", directory, i * 12)
        size = _TYPE_SIZES.get(typ, 1) * count
        if size <= 4:
            value_bytes = directory[i * 12 + 8 : i * 12 + 8 + size]
            tags[tag] = _decode_tag(bo, typ, count, value_bytes)
        else:
            value_offset = struct.unpack_from(bo + "I", directory, i * 12 + 8)[0]
            deferred.append((tag, typ, count, value_offset, size))
    for tag, typ, count, value_offset, size in deferred:
        f.seek(value_offset)
        tags[tag] = _decode_tag(bo, typ, count, f.read(size))
    return tags


def _decode_tag(bo: str, typ: int, count: int, value_bytes: bytes) -> tuple:
    if typ in _TYPE_FMT:
        return struct.unpack(bo + _TYPE_FMT[typ] * count, value_bytes)
    if typ == 5:  # RATIONAL
        raw = struct.unpack(bo + "I" * (2 * count), value_bytes)
        return tuple(raw[2 * i] / raw[2 * i + 1] for i in range(count))
    return (value_bytes,)


def _dtype_for(bits: int, sample_format: int, bo: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
    return np.dtype(f"{'<' if bo == '<' else '>'}{kind}{bits // 8}")


def _epsg_from_geokeys(values: Tuple[int, ...]) -> str:
    # GeoKeyDirectory: header of 4 shorts then (key, loc, count, value) rows
    epsg = None
    for i in range(4, len(values) - 3, 4):
        key, loc, _count, value = values[i : i + 4]
        if key in (2048, 3072) and loc == 0:  # geographic / projected CRS
            epsg = value
            if key == 3072:  # projected takes precedence
                break
    return f"epsg:{epsg}" if epsg else "epsg:unknown"


class GeoTiffWindowReader:
    """Windowed (strip/tile-wise) GeoTIFF reads for grids larger than RAM.

    The header and IFD are parsed once with file seeks; the pixel payload is
    decoded on demand per requested row/column window — only the strips or
    tiles that intersect the window are read and decompressed. This is the
    ingest half of the out-of-core story (SURVEY.md §7 step 7): it feeds
    :class:`~topo_descriptors_tpu_torch.parallel.tiles.TiledRunner` row bands and
    per-host mesh blocks without ever materializing the full mosaic (the
    reference's dask path, topo.py:177-178, streams *compute* but still
    opens the whole array through xarray).

    Supports the same subset as :func:`read_geotiff` (which is now a thin
    full-window wrapper over this class). Also usable via ``with``; row
    slicing (``reader[a:b]`` / ``reader[a:b, c:d]``) delegates to
    :meth:`read_rows`, which lets the reader stand in for a numpy DEM in
    band-streaming loops.
    """

    def __init__(self, path, name: str = "DEM"):
        self.name = name
        self.units = "m"
        self._f = open(path, "rb")
        head = self._f.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError("not a TIFF file")
        magic, ifd_offset = struct.unpack_from(bo + "HI", head, 2)
        if magic == 43:
            raise ValueError("BigTIFF is not supported (classic TIFF only)")
        if magic != 42:
            raise ValueError("not a TIFF file")
        self._bo = bo
        tags = _read_ifd_file(self._f, bo, ifd_offset)

        self.width = tags[_W][0]
        self.height = tags[_H][0]
        bits = tags.get(_BITS, (32,))[0]
        self._comp = tags.get(_COMP, (1,))[0]
        fmt = tags.get(_SAMPLE_FORMAT, (1,))[0]
        self._predictor = tags.get(_PREDICTOR, (1,))[0]
        spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
        if spp != 1:
            raise ValueError(
                f"only single-band rasters supported, got {spp} bands"
            )
        if self._comp not in (1, 8, 32946):
            raise ValueError(
                f"unsupported compression {self._comp} (none/deflate only)"
            )
        self.dtype = _dtype_for(bits, fmt, bo)

        if _TILE_OFFSETS in tags:
            self._tiled = True
            self._tw, self._th = tags[_TILE_W][0], tags[_TILE_H][0]
            self._offsets = tags[_TILE_OFFSETS]
            self._counts = tags[_TILE_COUNTS]
        else:
            self._tiled = False
            self._rps = tags.get(_ROWS_PER_STRIP, (self.height,))[0]
            self._offsets = tags[_STRIP_OFFSETS]
            self._counts = tags[_STRIP_COUNTS]
        self.chunks_decoded = 0  # observability: strip/tile decode counter

        scale = tags.get(_PIXEL_SCALE, (1.0, 1.0, 0.0))
        tie = tags.get(_TIEPOINT, (0.0, 0.0, 0.0, 0.0, 0.0, 0.0))
        sx, sy = float(scale[0]), float(scale[1])
        x0, y0 = float(tie[3]), float(tie[4])
        x_coords = x0 + (np.arange(self.width) + 0.5) * sx
        y_coords = y0 - (np.arange(self.height) + 0.5) * sy
        crs = "epsg:unknown"
        if _GEO_KEYS in tags:
            crs = _epsg_from_geokeys(tags[_GEO_KEYS])
        self.grid = RasterGrid(y=y_coords, x=x_coords, crs=crs)

    # -- protocol -----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, key) -> np.ndarray:
        rows, cols = key if isinstance(key, tuple) else (key, slice(None))
        r0, r1, step = rows.indices(self.height)
        c0, c1, cstep = cols.indices(self.width)
        if step != 1 or cstep != 1:
            raise ValueError("windowed reads support contiguous slices only")
        return self.read_rows(r0, r1, c0, c1)

    # -- decoding -----------------------------------------------------------
    def _decode(self, index: int, rows: int, cols: int) -> np.ndarray:
        self._f.seek(self._offsets[index])
        chunk = self._f.read(self._counts[index])
        if self._comp in (8, 32946):
            chunk = zlib.decompress(chunk)
        arr = np.frombuffer(chunk, dtype=self.dtype, count=rows * cols)
        arr = arr.reshape(rows, cols)
        if self._predictor == 2:
            arr = np.cumsum(arr.astype(np.int64), axis=1).astype(self.dtype)
        self.chunks_decoded += 1
        return arr

    def read_rows(
        self, r0: int, r1: int, c0: int = 0, c1: Optional[int] = None
    ) -> np.ndarray:
        """Decode the window ``[r0:r1, c0:c1]`` -> native-dtype ndarray.

        Strip files decode the strips overlapping ``[r0, r1)`` (full width,
        then column-sliced); tile files decode only tiles intersecting the
        window in *both* axes.
        """
        if c1 is None:
            c1 = self.width
        if not (0 <= r0 <= r1 <= self.height and 0 <= c0 <= c1 <= self.width):
            raise ValueError(f"window [{r0}:{r1}, {c0}:{c1}] out of bounds")
        out = np.zeros((r1 - r0, c1 - c0), dtype=self.dtype)
        if r1 == r0 or c1 == c0:
            return out
        if self._tiled:
            tw, th = self._tw, self._th
            tiles_across = -(-self.width // tw)
            for ty in range(r0 // th, -(-r1 // th)):
                for tx in range(c0 // tw, -(-c1 // tw)):
                    tile = self._decode(ty * tiles_across + tx, th, tw)
                    y0, x0 = ty * th, tx * tw
                    ys0, xs0 = max(r0, y0), max(c0, x0)
                    ys1 = min(r1, y0 + th, self.height)
                    xs1 = min(c1, x0 + tw, self.width)
                    out[ys0 - r0 : ys1 - r0, xs0 - c0 : xs1 - c0] = tile[
                        ys0 - y0 : ys1 - y0, xs0 - x0 : xs1 - x0
                    ]
        else:
            rps = self._rps
            for s in range(r0 // rps, -(-r1 // rps)):
                row = s * rps
                rows = min(rps, self.height - row)
                strip = self._decode(s, rows, self.width)
                ys0, ys1 = max(r0, row), min(r1, row + rows)
                out[ys0 - r0 : ys1 - r0] = strip[ys0 - row : ys1 - row, c0:c1]
        return out.astype(out.dtype.newbyteorder("="))

    def to_raster(self) -> Raster:
        return Raster(
            data=self.read_rows(0, self.height),
            grid=self.grid,
            name=self.name,
            units=self.units,
        )


def read_geotiff(path, name: str = "DEM") -> Raster:
    """Read a single-band GeoTIFF into a :class:`Raster` (full window of
    :class:`GeoTiffWindowReader`)."""
    with GeoTiffWindowReader(path, name) as reader:
        return reader.to_raster()


def write_geotiff(
    raster: Raster,
    path,
    compress: bool = True,
    rows_per_strip: Optional[int] = None,
    tile: Optional[Tuple[int, int]] = None,
) -> None:
    """Write a single-band float32 GeoTIFF (deflate, EPSG geokeys).

    Requires a uniformly spaced grid (GeoTIFF's affine model); coordinates
    are written back from the pixel-centre convention.

    ``rows_per_strip`` selects a multi-strip layout and ``tile=(th, tw)`` a
    tiled layout (tile dims must be multiples of 16 per the TIFF spec) —
    both make the file window-addressable for
    :class:`GeoTiffWindowReader`, which then reads only the chunks a
    window intersects. Default remains one whole-image strip.
    """
    data = np.asarray(raster.data, dtype=np.float32)
    h, w = data.shape
    x, y = np.asarray(raster.grid.x, np.float64), np.asarray(
        raster.grid.y, np.float64
    )
    sx = float(x[1] - x[0]) if w > 1 else 1.0
    sy = float(y[0] - y[1]) if h > 1 else 1.0
    if w > 2 and not np.allclose(np.diff(x), sx, rtol=1e-6):
        raise ValueError("GeoTIFF requires uniform x spacing")
    if h > 2 and not np.allclose(-np.diff(y), sy, rtol=1e-6):
        raise ValueError("GeoTIFF requires uniform y spacing")
    x0 = float(x[0]) - 0.5 * sx
    y0 = float(y[0]) + 0.5 * sy
    epsg = 0
    crs = raster.grid.crs.lower()
    if "epsg:" in crs:
        tail = crs.split("epsg:")[1]
        if tail.isdigit():
            epsg = int(tail)
    is_geographic = epsg == 4326

    def pack(chunk: np.ndarray) -> bytes:
        raw = np.ascontiguousarray(chunk).tobytes()
        return zlib.compress(raw, 6) if compress else raw

    if tile is not None:
        th, tw = int(tile[0]), int(tile[1])
        if th % 16 or tw % 16:
            raise ValueError("TIFF tile dims must be multiples of 16")
        chunks = []
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                # edge tiles are zero-padded to full tile size (TIFF spec)
                full = np.zeros((th, tw), dtype=np.float32)
                block = data[ty : ty + th, tx : tx + tw]
                full[: block.shape[0], : block.shape[1]] = block
                chunks.append(pack(full))
    else:
        rps = int(rows_per_strip) if rows_per_strip else h
        chunks = [pack(data[r : r + rps]) for r in range(0, h, rps)]

    bo = "<"
    header = struct.pack(bo + "2sHI", b"II", 42, 8)

    # values larger than 4 bytes live after the IFD; lay out: header, IFD,
    # out-of-line values, strip data
    entries = []

    def entry(tag, typ, values, fmt):
        entries.append((tag, typ, values, fmt))

    geo_keys = [1, 1, 0, 2,  # version, rev, minor, number of keys
                1024, 0, 1, 2 if is_geographic else 1,  # model type
                2048 if is_geographic else 3072, 0, 1, epsg]
    n_chunks = len(chunks)
    counts = tuple(len(c) for c in chunks)
    entry(_W, 4, (w,), "I")
    entry(_H, 4, (h,), "I")
    entry(_BITS, 3, (32,), "H")
    entry(_COMP, 3, (8 if compress else 1,), "H")
    entry(_PHOTO, 3, (1,), "H")
    entry(_SAMPLES_PER_PIXEL, 3, (1,), "H")
    if tile is not None:
        entry(_TILE_W, 4, (tw,), "I")
        entry(_TILE_H, 4, (th,), "I")
        offsets_tag, counts_tag = _TILE_OFFSETS, _TILE_COUNTS
    else:
        entry(_ROWS_PER_STRIP, 4, (rps,), "I")
        offsets_tag, counts_tag = _STRIP_OFFSETS, _STRIP_COUNTS
    entry(offsets_tag, 4, (0,) * n_chunks, "I")  # rewritten once laid out
    entry(counts_tag, 4, counts, "I")
    entry(_SAMPLE_FORMAT, 3, (3,), "H")
    entry(_PIXEL_SCALE, 12, (sx, sy, 0.0), "d")
    entry(_TIEPOINT, 12, (0.0, 0.0, 0.0, x0, y0, 0.0), "d")
    entry(_GEO_KEYS, 3, tuple(geo_keys), "H")

    entries.sort(key=lambda e: e[0])
    ifd_offset = 8
    ifd_size = 2 + len(entries) * 12 + 4

    def layout(entry_list):
        """Pack the IFD + out-of-line value area for a fixed entry list."""
        extra_offset = ifd_offset + ifd_size
        extra = b""
        packed = []
        for tag, typ, values, fmt in entry_list:
            raw = struct.pack(bo + fmt * len(values), *values)
            if len(raw) <= 4:
                value_field = raw.ljust(4, b"\0")
            else:
                value_field = struct.pack(bo + "I", extra_offset + len(extra))
                extra += raw
            packed.append((tag, typ, len(values), value_field))
        return packed, extra

    # first pass fixes the byte layout (sizes don't depend on the offset
    # values), second pass writes the true chunk offsets
    _, extra = layout(entries)
    data_offset = ifd_offset + ifd_size + len(extra)
    chunk_offsets, pos = [], data_offset
    for c in counts:
        chunk_offsets.append(pos)
        pos += c
    entries = [
        (tag, typ, tuple(chunk_offsets) if tag == offsets_tag else values, fmt)
        for tag, typ, values, fmt in entries
    ]
    packed, extra = layout(entries)

    out = bytearray(header)
    out += struct.pack(bo + "H", len(packed))
    for tag, typ, cnt, value_field in packed:
        out += struct.pack(bo + "HHI", tag, typ, cnt) + value_field
    out += struct.pack(bo + "I", 0)  # next IFD
    out += extra
    for c in chunks:
        out += c
    Path(path).write_bytes(bytes(out))
