"""Minimal HDF5 writer and reader for the files this package writes.

The matrix .h5 and molecule_info.h5 writers need only a small subset of
HDF5: groups, attributes, and contiguous datasets of integers, floats,
fixed-length byte strings and variable-length UTF-8 strings (scalar or
1-D/2-D). This module writes exactly that subset in the version-2 file
format (superblock v2, v2 object headers with compact links) so that
h5py and the HDF5 library read it unchanged, and reads it back without
h5py. Data is stored uncompressed and unchunked.

    with File(path, "w") as f:
        f.attrs["version"] = 2
        g = f.create_group("matrix")
        g.create_dataset("data", data=np.arange(3, dtype=np.int32))

    with File(path, "r") as f:
        f["matrix/data"][:], f.attrs["version"]

`open_h5(path)` opens a file for reading with h5py where it is installed
(it reads any HDF5 file) and with this reader otherwise.
"""

from __future__ import annotations

import struct

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_M32 = 0xFFFFFFFF

# object-header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL, _LINK = 0x01, 0x02, 0x03, 0x05, 0x06
_LAYOUT, _GROUP_INFO, _ATTRIBUTE = 0x08, 0x0A, 0x0C


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 hashlittle, HDF5's metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & _M32

    i = 0
    while n > 12:
        a = (a + int.from_bytes(data[i:i + 4], "little")) & _M32
        b = (b + int.from_bytes(data[i + 4:i + 8], "little")) & _M32
        c = (c + int.from_bytes(data[i + 8:i + 12], "little")) & _M32
        a = (a - c) & _M32; a ^= rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= rot(b, 4); b = (b + a) & _M32
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = data[i:] + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], "little")) & _M32
    b = (b + int.from_bytes(tail[4:8], "little")) & _M32
    c = (c + int.from_bytes(tail[8:12], "little")) & _M32
    c ^= b; c = (c - rot(b, 14)) & _M32
    a ^= c; a = (a - rot(c, 11)) & _M32
    b ^= a; b = (b - rot(a, 25)) & _M32
    c ^= b; c = (c - rot(b, 16)) & _M32
    a ^= c; a = (a - rot(c, 4)) & _M32
    b ^= a; b = (b - rot(a, 14)) & _M32
    c ^= b; c = (c - rot(b, 24)) & _M32
    return c


# ------------------------------------------------------------------ writer
class _VlenStr:
    """Marker for values stored as variable-length UTF-8 strings (what
    h5py makes of a Python str)."""

    def __init__(self, values, shape):
        self.values = [v.encode() for v in values]
        self.shape = shape


def _normalize(value):
    """Python/numpy value -> numpy array or _VlenStr, as h5py stores it."""
    if isinstance(value, str):
        return _VlenStr([value], ())
    arr = np.asarray(value)
    if arr.dtype.kind not in "iufS":
        raise TypeError(f"h5lite cannot store dtype {arr.dtype}")
    return arr


def _dtype_msg(arr) -> bytes:
    if isinstance(arr, _VlenStr):
        base = _dtype_msg(np.zeros(0, np.uint8))
        # class 9 (vlen) v1; type 1 = string, pad 0, charset 1 = UTF-8
        return bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16) + base
    dt = arr.dtype
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return (bytes([0x10, bits, 0, 0]) + struct.pack("<I", size)
                + struct.pack("<HH", 0, 8 * size))
    if dt.kind == "f":
        if size == 4:
            sign, eloc, esz, msz, bias = 31, 23, 8, 23, 127
        elif size == 8:
            sign, eloc, esz, msz, bias = 63, 52, 11, 52, 1023
        else:
            raise TypeError(f"h5lite cannot store {dt}")
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esz, 0, msz,
                              bias))
    # fixed-length bytes: class 3 v1, null-padded ASCII
    return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", size)


def _space_msg(shape) -> bytes:
    if shape == ():
        return bytes([2, 0, 0, 0])
    return bytes([2, len(shape), 0, 1]) + b"".join(
        struct.pack("<Q", int(d)) for d in shape)


class _Node:
    def __init__(self):
        self.attrs: dict = {}


class WDataset(_Node):
    def __init__(self, data):
        super().__init__()
        self.data = _normalize(data)


class WGroup(_Node):
    def __init__(self):
        super().__init__()
        self.children: dict = {}

    def create_group(self, name: str) -> "WGroup":
        g = self.children[name] = WGroup()
        return g

    def create_dataset(self, name: str, data) -> WDataset:
        d = self.children[name] = WDataset(data)
        return d


class _Buf:
    def __init__(self):
        self.b = bytearray(48)           # superblock, written last

    def put(self, data: bytes, align: int = 8) -> int:
        self.b += bytes(-len(self.b) % align)
        addr = len(self.b)
        self.b += data
        return addr


class Writer(WGroup):
    """Root group of a file being written; serialized by close()."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()

    def close(self):
        buf = _Buf()
        root = self._write_group(buf, self)
        eof = len(buf.b)
        sb = (b"\x89HDF\r\n\x1a\n" + bytes([2, 8, 8, 0])
              + struct.pack("<QQQQ", 0, UNDEF, eof, root))
        buf.b[:48] = sb + struct.pack("<I", lookup3(sb))
        with open(self.path, "wb") as f:
            f.write(bytes(buf.b))

    # -- serialization
    def _vlen_elems(self, buf, v: _VlenStr) -> bytes:
        """Write the strings into one global heap collection; return the
        16-byte (length, collection address, index) elements."""
        objs = bytearray()
        for i, s in enumerate(v.values):
            objs += struct.pack("<HHIQ", i + 1, 1, 0, len(s))
            objs += s + bytes(-len(s) % 8)
        size = max(4096, 16 + len(objs) + 16)
        size += -size % 8
        free = size - 16 - len(objs)
        heap = (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size)
                + bytes(objs) + struct.pack("<HHIQ", 0, 0, 0, free)
                + bytes(free - 16))
        addr = buf.put(heap)
        return b"".join(struct.pack("<IQI", len(s), addr, i + 1)
                        for i, s in enumerate(v.values))

    def _raw(self, buf, arr) -> bytes:
        if isinstance(arr, _VlenStr):
            return self._vlen_elems(buf, arr)
        return np.ascontiguousarray(arr).astype(
            arr.dtype.newbyteorder("<"), copy=False).tobytes()

    def _attr_msgs(self, buf, node) -> list:
        msgs = []
        for name, value in node.attrs.items():
            arr = _normalize(value)
            dtm, spm = _dtype_msg(arr), _space_msg(arr.shape)
            nb = name.encode() + b"\0"
            body = (struct.pack("<BBHHHB", 3, 0, len(nb), len(dtm), len(spm),
                                0) + nb + dtm + spm + self._raw(buf, arr))
            msgs.append((_ATTRIBUTE, 0, body))
        return msgs

    def _write_group(self, buf, g: WGroup) -> int:
        msgs = [(_LINK_INFO, 0, bytes([0, 0]) + struct.pack("<QQ", UNDEF,
                                                              UNDEF)),
                (_GROUP_INFO, 0, bytes([0, 0]))]
        for name, child in g.children.items():
            addr = (self._write_group(buf, child)
                    if isinstance(child, WGroup)
                    else self._write_dataset(buf, child))
            nb = name.encode()
            assert len(nb) < 256, name
            msgs.append((_LINK, 0, bytes([1, 0, len(nb)]) + nb
                         + struct.pack("<Q", addr)))
        msgs += self._attr_msgs(buf, g)
        return self._write_header(buf, msgs)

    def _write_dataset(self, buf, d: WDataset) -> int:
        arr = d.data
        raw = self._raw(buf, arr)
        addr = buf.put(raw) if raw else UNDEF
        msgs = [(_DATASPACE, 0, _space_msg(arr.shape)),
                (_DATATYPE, 1, _dtype_msg(arr)),
                (_FILL, 1, bytes([3, 0x0A])),
                (_LAYOUT, 0, bytes([3, 1]) + struct.pack("<QQ", addr,
                                                         len(raw)))]
        msgs += self._attr_msgs(buf, d)
        return self._write_header(buf, msgs)

    @staticmethod
    def _write_header(buf, msgs) -> int:
        body = b"".join(struct.pack("<BHB", t, len(m), fl) + m
                        for t, fl, m in msgs)
        head = b"OHDR" + bytes([2, 2]) + struct.pack("<I", len(body)) + body
        return buf.put(head + struct.pack("<I", lookup3(head)))


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, data: bytes):
        self.d = data

    def header(self, addr: int) -> list:
        d = self.d
        assert d[addr:addr + 4] == b"OHDR", "not a v2 object header"
        flags = d[addr + 5]
        p = addr + 6
        if flags & 0x20:
            p += 16
        if flags & 0x10:
            p += 4
        nsz = 1 << (flags & 3)
        size = int.from_bytes(d[p:p + nsz], "little")
        p += nsz
        end = p + size
        out = []
        while p + 4 <= end:
            t, n, fl = struct.unpack_from("<BHB", d, p)
            p += 4
            if flags & 0x04:
                p += 2
            out.append((t, d[p:p + n]))
            p += n
        return out

    def dtype(self, m: bytes):
        """-> (numpy dtype or "vlen_str", message length)."""
        cls, size = m[0] & 0x0F, struct.unpack_from("<I", m, 4)[0]
        if cls == 0:
            kind = "i" if m[1] & 0x08 else "u"
            return np.dtype(f"<{kind}{size}"), 12
        if cls == 1:
            return np.dtype(f"<f{size}"), 20
        if cls == 3:
            return np.dtype(f"S{size}"), 8
        if cls == 9 and m[1] & 0x0F == 1:
            _, blen = self.dtype(m[8:])
            return "vlen_str", 8 + blen
        raise ValueError(f"unsupported HDF5 datatype class {cls}")

    @staticmethod
    def shape(m: bytes) -> tuple:
        assert m[0] == 2, "dataspace message v2 expected"
        rank = m[1]
        return tuple(struct.unpack_from(f"<{rank}Q", m, 4)) if rank else ()

    def values(self, dt, shape, raw: bytes):
        if dt == "vlen_str":
            assert shape == (), "only scalar variable-length strings"
            ln, addr, idx = struct.unpack_from("<IQI", raw, 0)
            return self.heap_obj(addr, idx)[:ln] if ln else b""
        n = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(raw, dt, count=n).copy()
        return arr.reshape(shape) if shape else arr[0]

    def heap_obj(self, addr: int, idx: int) -> bytes:
        d = self.d
        assert d[addr:addr + 4] == b"GCOL"
        size = struct.unpack_from("<Q", d, addr + 8)[0]
        p, end = addr + 16, addr + size
        while p + 16 <= end:
            i, _, _, n = struct.unpack_from("<HHIQ", d, p)
            if i == idx:
                return d[p + 16:p + 16 + n]
            if i == 0:
                break
            p += 16 + n + (-n % 8)
        raise KeyError(f"global heap object {idx} not found")

    def attrs(self, msgs) -> dict:
        out = {}
        for t, m in msgs:
            if t != _ATTRIBUTE:
                continue
            ver, _, nlen, tlen, slen = struct.unpack_from("<BBHHH", m, 0)
            assert ver == 3, "attribute message v3 expected"
            p = 9
            name = m[p:p + nlen].rstrip(b"\0").decode()
            p += nlen
            dt, _ = self.dtype(m[p:p + tlen])
            shape = self.shape(m[p + tlen:p + tlen + slen])
            v = self.values(dt, shape, m[p + tlen + slen:])
            out[name] = v.decode() if dt == "vlen_str" else v
        return out


class Dataset:
    def __init__(self, r: _Reader, msgs):
        self._r = r
        self.attrs = r.attrs(msgs)
        m = dict((t, v) for t, v in msgs)
        self.shape = r.shape(m[_DATASPACE])
        self.dtype, _ = r.dtype(m[_DATATYPE])
        lay = m[_LAYOUT]
        assert lay[:2] == bytes([3, 1]), "contiguous layout v3 expected"
        self._addr, self._size = struct.unpack_from("<QQ", lay, 2)

    def __getitem__(self, key):
        raw = (b"" if self._addr == UNDEF
               else self._r.d[self._addr:self._addr + self._size])
        v = self._r.values(self.dtype, self.shape, raw)
        return v if key == () else v[key]


class Group:
    def __init__(self, r: _Reader, msgs):
        self._r = r
        self.attrs = r.attrs(msgs)
        self._links = {}
        for t, m in msgs:
            if t == _LINK:
                assert m[0] == 1 and m[1] == 0, "plain hard links expected"
                n = m[2]
                self._links[m[3:3 + n].decode()] = struct.unpack_from(
                    "<Q", m, 3 + n)[0]

    def keys(self):
        return sorted(self._links)

    def __getitem__(self, name: str):
        node = self
        for part in name.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(name)
            msgs = self._r.header(node._links[part])
            is_group = any(t == _LINK_INFO for t, _ in msgs)
            node = (Group if is_group else Dataset)(self._r, msgs)
        return node


class Reader(Group):
    """Root group of a file opened for reading."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:8] != b"\x89HDF\r\n\x1a\n" or data[8] != 2:
            raise ValueError(f"{path}: not an HDF5 file with a v2 superblock")
        root = struct.unpack_from("<Q", data, 36)[0]
        r = _Reader(data)
        super().__init__(r, r.header(root))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def File(path: str, mode: str = "r"):
    """h5py-style opener: mode "w" returns a Writer, "r" a Reader."""
    if mode == "w":
        return Writer(path)
    if mode == "r":
        return Reader(path)
    raise ValueError(f"unsupported mode {mode!r}")


def open_h5(path: str):
    """Open for reading with h5py where it is installed, else this reader."""
    try:
        import h5py
    except ImportError:
        return Reader(path)
    return h5py.File(path, "r")
