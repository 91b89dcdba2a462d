"""A Zstandard decoder (RFC 8878) in Python and numpy.

The JAX package's orbax checkpoints hold every array as a zstd-compressed
zarr chunk inside zstd-compressed OCDBT nodes (``utils/ocdbt.py``); this
module reads them where no ``zstandard`` package is installed. It decodes
every frame the format allows without a dictionary: all frame-header forms,
skippable frames, several frames in one buffer, raw, RLE and compressed
blocks, raw, RLE and Huffman literals (1 or 4 streams, treeless ones
reusing the previous table), predefined, RLE, FSE-compressed and repeated
sequence tables, the three repeat offsets, and the content checksum (the
low 32 bits of XXH64).

Entry point: :func:`decompress`. Corrupt input raises a ``ValueError``
naming the byte offset of the frame or block at fault; the decoder never
returns short output.

Speed: the Huffman and sequence loops run one symbol at a time in Python
(a few MB/s); the checkpoints it serves are a few MB at most.
"""

from __future__ import annotations

import struct

import numpy as np

ZSTD_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE_MAGIC = 0x184D2A50
_BLOCK_MAX = 128 * 1024
_PAD_BITS = 64  # zero bits in front of every backward stream (Huffman peeks read past its start)

_M64 = (1 << 64) - 1
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261

# Literals-length and match-length codes: (baseline, extra bits), RFC 8878 3.1.1.3.2.1.1.
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# Predefined distributions, RFC 8878 3.1.1.3.2.2.
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1]
# (largest symbol, largest accuracy log) of each sequence table.
_LL_MAX, _ML_MAX, _OF_MAX = (35, 9), (52, 9), (31, 8)


class _Corrupt(Exception):
    """A fault inside a block; :func:`decompress` adds the offset."""


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the hash whose low 32 bits zstd's
    checksum keeps)."""
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (_P1 + _P2) & _M64
        v2 = _P2
        v3 = 0
        v4 = -_P1 & _M64
        stop = n - n % 32
        for a, b, c, d in struct.iter_unpack("<4Q", data[:stop]):
            v1 = (_rotl((v1 + a * _P2) & _M64, 31) * _P1) & _M64
            v2 = (_rotl((v2 + b * _P2) & _M64, 31) * _P1) & _M64
            v3 = (_rotl((v3 + c * _P2) & _M64, 31) * _P1) & _M64
            v4 = (_rotl((v4 + d * _P2) & _M64, 31) * _P1) & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = (((h ^ _round(0, v)) * _P1) + _P4) & _M64
        pos = stop
    else:
        h = _P5
    h = (h + n) & _M64
    while pos + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, pos)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, pos)
        h = (_rotl(h ^ ((lane * _P1) & _M64), 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h = (_rotl(h ^ ((data[pos] * _P5) & _M64), 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def _backward(stream) -> tuple[list, int]:
    """A backward bit stream as 64-bit little-endian windows, one per byte
    offset, over the stream with :data:`_PAD_BITS` zero bits in front; and
    the bit position just under its end marker (the highest set bit of the
    last byte). ``n`` bits ending at position ``p`` are
    ``(win[(p - n) >> 3] >> ((p - n) & 7)) & mask``."""
    if not stream or stream[-1] == 0:
        raise _Corrupt("a backward bit stream does not end in its marker bit")
    buf = np.frombuffer(bytes(_PAD_BITS // 8) + bytes(stream) + bytes(8), np.uint8)
    n = len(buf) - 8
    win = np.zeros(n, np.uint64)
    for k in range(8):
        win |= buf[k : k + n].astype(np.uint64) << np.uint64(8 * k)
    top = _PAD_BITS + 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
    return win.tolist(), top


def _read_fse_counts(data, pos: int, end: int, max_symbol: int, max_log: int):
    """An FSE table description at ``data[pos:end]``: ``(counts,
    accuracy_log, bytes_read)``; ``-1`` is a "less than one" count."""
    head = bytes(data[pos : min(end, pos + 1024)])
    if not head:
        raise _Corrupt("an FSE table description is missing")
    bits = int.from_bytes(head, "little")
    log = (bits & 15) + 5
    if log > max_log:
        raise _Corrupt(f"FSE accuracy log {log} above {max_log}")
    cursor = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts: list[int] = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise _Corrupt("an FSE table names a symbol beyond the largest")
        low = (bits >> cursor) & (threshold - 1)
        top = 2 * threshold - 1 - remaining
        if low < top:
            value = low
            cursor += nb - 1
        else:
            value = (bits >> cursor) & (2 * threshold - 1)
            if value >= threshold:
                value -= top
            cursor += nb
        count = value - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = (bits >> cursor) & 3
                cursor += 2
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise _Corrupt("an FSE table names a symbol beyond the largest")
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    used = (cursor + 7) >> 3
    if remaining != 1 or used > len(head):
        raise _Corrupt("an FSE table description does not sum to its table size")
    return counts, log, used


def _fse_table(counts: list[int], log: int):
    """The decoding table of a normalised distribution: three lists over
    the states (symbol, bits to read, baseline of the next state)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    position = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[position] = s
            position = (position + step) & mask
            while position > high:
                position = (position + step) & mask
    if position != 0:
        raise _Corrupt("an FSE distribution does not fill its table")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = symbols[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        nbits[u] = nb
        base[u] = (state << nb) - size
    return symbols, nbits, base


_LL_TABLE = _fse_table(_LL_DEFAULT, 6)
_ML_TABLE = _fse_table(_ML_DEFAULT, 6)
_OF_TABLE = _fse_table(_OF_DEFAULT, 5)


def _huffman_weights(data, pos: int, end: int) -> tuple[list[int], int]:
    """A Huffman tree description at ``data[pos:end]``: the weights of all
    symbols but the last, and the bytes it takes."""
    if pos >= end:
        raise _Corrupt("a Huffman tree description is missing")
    header = data[pos]
    if header >= 128:
        n = header - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            raise _Corrupt("a Huffman tree description runs past its block")
        raw = data[pos + 1 : pos + 1 + size]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], 1 + size
    stop = pos + 1 + header
    if stop > end:
        raise _Corrupt("a Huffman tree description runs past its block")
    counts, log, used = _read_fse_counts(data, pos + 1, stop, 255, 6)
    symbols, nbits, base = _fse_table(counts, log)
    win, p = _backward(data[pos + 1 + used : stop])

    def read(n):
        nonlocal p
        p -= n
        q = max(p, 0)  # past the stream's start only zeros are read (and p < 64 ends it)
        return (win[q >> 3] >> (q & 7)) & ((1 << n) - 1) if n else 0

    s1 = read(log)
    s2 = read(log)
    if p < _PAD_BITS:
        raise _Corrupt("a Huffman weight stream ends before its states")
    weights = []
    states = [s1, s2]
    turn = 0
    while True:
        if len(weights) >= 255:
            raise _Corrupt("a Huffman tree description holds more than 255 weights")
        s = states[turn]
        weights.append(symbols[s])
        states[turn] = base[s] + read(nbits[s])
        if p < _PAD_BITS:
            weights.append(symbols[states[1 - turn]])
            break
        turn = 1 - turn
    return weights, 1 + header


def _huffman_table(weights: list[int]) -> tuple[list[int], int]:
    """The decoding table (``symbol | bits << 8``, indexed by the next
    ``max_bits`` bits) of the weights, the last symbol's weight implied."""
    if any(w > 11 for w in weights):
        raise _Corrupt("a Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise _Corrupt("a Huffman tree with no weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > 11:
        raise _Corrupt("Huffman weights that complete no tree")
    weights = weights + [rest.bit_length()]
    table = [0] * (1 << max_bits)
    position = 0
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                length = 1 << (w - 1)
                entry = s | ((max_bits + 1 - w) << 8)
                table[position : position + length] = [entry] * length
                position += length
    return table, max_bits


def _huffman_stream(stream, table: list[int], max_bits: int, count: int) -> bytes:
    win, p = _backward(stream)
    out = bytearray(count)
    mask = (1 << max_bits) - 1
    floor = _PAD_BITS
    for i in range(count):
        q = p - max_bits
        if q < 0:
            raise _Corrupt("a Huffman stream ends before its literals")
        e = table[(win[q >> 3] >> (q & 7)) & mask]
        out[i] = e & 255
        p -= e >> 8
    if p != floor:
        raise _Corrupt("a Huffman stream's bits do not end with its literals")
    return bytes(out)


class _FrameState:
    def __init__(self, window: int):
        self.window = window
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data, pos: int, end: int, st: _FrameState) -> tuple[bytes, int]:
    """The literals section at ``data[pos:end]``: its bytes and its size."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, head = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        if kind == 0:
            if pos + head + size > end:
                raise _Corrupt("raw literals run past their block")
            return bytes(data[pos + head : pos + head + size]), head + size
        if pos + head >= end:
            raise _Corrupt("RLE literals run past their block")
        return bytes([data[pos + head]]) * size, head + 1
    head, width = [(3, 10), (3, 10), (4, 14), (5, 18)][fmt]
    if pos + head > end:
        raise _Corrupt("a literals header runs past its block")
    h = int.from_bytes(bytes(data[pos : pos + head]), "little")
    mask = (1 << width) - 1
    size, comp = (h >> 4) & mask, (h >> (4 + width)) & mask
    start, stop = pos + head, pos + head + comp
    if stop > end:
        raise _Corrupt("compressed literals run past their block")
    if size > _BLOCK_MAX:
        raise _Corrupt("literals larger than a block")
    if kind == 2:
        weights, used = _huffman_weights(data, start, stop)
        st.huffman = _huffman_table(weights)
        start += used
    elif st.huffman is None:
        raise _Corrupt("treeless literals with no previous Huffman table")
    table, max_bits = st.huffman
    if fmt == 0:
        return _huffman_stream(data[start:stop], table, max_bits, size), head + comp
    if stop - start < 6:
        raise _Corrupt("a four-stream jump table runs past its literals")
    s1, s2, s3 = struct.unpack_from("<3H", data, start)
    seg = (size + 3) // 4
    last = size - 3 * seg
    a = start + 6
    bounds = [a, a + s1, a + s1 + s2, a + s1 + s2 + s3, stop]
    if last < 0 or bounds[3] >= stop:
        raise _Corrupt("a four-stream jump table that does not fit its literals")
    parts = [
        _huffman_stream(data[bounds[i] : bounds[i + 1]], table, max_bits, seg if i < 3 else last)
        for i in range(4)
    ]
    return b"".join(parts), head + comp


def _sequence_table(data, pos, end, mode, key, default, limits, st):
    """One sequence table by its mode; returns the bytes it takes."""
    if mode == 0:
        st.tables[key] = default
        return 0
    if mode == 1:
        if pos >= end or data[pos] > limits[0]:
            raise _Corrupt("an RLE sequence table is missing or names a symbol beyond the largest")
        st.tables[key] = ([data[pos]], [0], [0])  # one state: the symbol, no bits
        return 1
    if mode == 2:
        counts, log, used = _read_fse_counts(data, pos, end, *limits)
        st.tables[key] = _fse_table(counts, log)
        return used
    if st.tables[key] is None:
        raise _Corrupt("a repeated sequence table with no previous table")
    return 0


def _block(data, pos: int, end: int, out: bytearray, st: _FrameState) -> None:
    """Decode the compressed block ``data[pos:end]`` onto ``out``."""
    lits, used = _literals(data, pos, end, st)
    pos += used
    if pos >= end:
        raise _Corrupt("a block ends before its sequences section")
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise _Corrupt("bytes after a block's last section")
        out += lits
        return
    if pos >= end:
        raise _Corrupt("a block ends before its table modes")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise _Corrupt("reserved bits set in the table modes")
    pos += _sequence_table(data, pos, end, modes >> 6, "ll", _LL_TABLE, _LL_MAX, st)
    pos += _sequence_table(data, pos, end, (modes >> 4) & 3, "of", _OF_TABLE, _OF_MAX, st)
    pos += _sequence_table(data, pos, end, (modes >> 2) & 3, "ml", _ML_TABLE, _ML_MAX, st)
    if pos >= end:
        raise _Corrupt("a block ends before its sequence bit stream")
    ll_sym, ll_nb, ll_base = st.tables["ll"]
    of_sym, of_nb, of_base = st.tables["of"]
    ml_sym, ml_nb, ml_base = st.tables["ml"]
    win, p = _backward(data[pos:end])
    floor = _PAD_BITS

    def read(n):
        nonlocal p
        p -= n
        if p < floor:
            raise _Corrupt("a sequence bit stream ends before its sequences")
        return (win[p >> 3] >> (p & 7)) & ((1 << n) - 1)

    ll_state = read(len(ll_sym).bit_length() - 1)
    of_state = read(len(of_sym).bit_length() - 1)
    ml_state = read(len(ml_sym).bit_length() - 1)
    rep1, rep2, rep3 = st.reps
    lp = 0
    nlits = len(lits)
    window = st.window
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_state], ml_sym[ml_state], ll_sym[ll_state]
        if of_code > 31:
            raise _Corrupt("an offset code above 31")
        p -= of_code
        if p < floor:
            raise _Corrupt("a sequence bit stream ends before its sequences")
        offset_value = (1 << of_code) + ((win[p >> 3] >> (p & 7)) & ((1 << of_code) - 1))
        n = _ML_BITS[ml_code]
        p -= n
        ml = _ML_BASE[ml_code] + ((win[p >> 3] >> (p & 7)) & ((1 << n) - 1))
        n = _LL_BITS[ll_code]
        p -= n
        ll = _LL_BASE[ll_code] + ((win[p >> 3] >> (p & 7)) & ((1 << n) - 1))
        if p < floor:
            raise _Corrupt("a sequence bit stream ends before its sequences")
        if offset_value > 3:
            offset = offset_value - 3
            rep1, rep2, rep3 = offset, rep1, rep2
        else:
            index = offset_value - (ll != 0)  # 0..3 once a literal length of 0 shifts it
            if index == 0:
                offset = rep1
            elif index == 1:
                offset, rep1, rep2 = rep2, rep2, rep1
            elif index == 2:
                offset, rep1, rep2, rep3 = rep3, rep3, rep1, rep2
            else:
                offset = rep1 - 1
                if offset == 0:
                    raise _Corrupt("a repeat offset of 0")
                rep1, rep2, rep3 = offset, rep1, rep2
        if i != nseq - 1:
            n = ll_nb[ll_state]
            p -= n
            ll_state = ll_base[ll_state] + ((win[p >> 3] >> (p & 7)) & ((1 << n) - 1))
            n = ml_nb[ml_state]
            p -= n
            ml_state = ml_base[ml_state] + ((win[p >> 3] >> (p & 7)) & ((1 << n) - 1))
            n = of_nb[of_state]
            p -= n
            if p < floor:
                raise _Corrupt("a sequence bit stream ends before its sequences")
            of_state = of_base[of_state] + ((win[p >> 3] >> (p & 7)) & ((1 << n) - 1))
        if lp + ll > nlits:
            raise _Corrupt("sequences take more literals than the block holds")
        if ll:
            out += lits[lp : lp + ll]
            lp += ll
        start = len(out) - offset
        if start < 0 or offset > window:
            raise _Corrupt(f"a match offset {offset} reaches before the frame or its window")
        if ml <= offset:
            out += out[start : start + ml]
        else:
            pattern = out[start:]
            reps, extra = divmod(ml, offset)
            out += pattern * reps + pattern[:extra]
    if p != floor:
        raise _Corrupt("a sequence bit stream's bits do not end with its sequences")
    st.reps = [rep1, rep2, rep3]
    out += lits[lp:]


def _frame(data, pos: int) -> tuple[bytes, int]:
    """Decode the zstd frame whose header starts at ``data[pos]`` (after the
    magic); returns its content and the position after it."""
    frame_start = pos - 4
    if pos >= len(data):
        raise ValueError(f"zstd: truncated frame header at byte {frame_start}")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ValueError(f"zstd: reserved bit set in the frame header at byte {frame_start}")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        exponent, mantissa = wd >> 3, wd & 7
        base = 1 << (10 + exponent)
        window = base + (base >> 3) * mantissa
    did_size = [0, 1, 2, 4][did_flag]
    dict_id = int.from_bytes(bytes(data[pos : pos + did_size]), "little")
    pos += did_size
    if dict_id:
        raise ValueError(
            f"zstd: the frame at byte {frame_start} names dictionary {dict_id}; "
            "this decoder reads frames without a dictionary only"
        )
    fcs_size = [1 if single else 0, 2, 4, 8][fcs_flag]
    if pos + fcs_size > len(data):
        raise ValueError(f"zstd: truncated frame header at byte {frame_start}")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(bytes(data[pos : pos + fcs_size]), "little")
        if fcs_size == 2:
            content_size += 256
        pos += fcs_size
    if window is None:
        window = content_size
    block_max = min(window, _BLOCK_MAX)
    st = _FrameState(window)
    out = bytearray()
    while True:
        if pos + 3 > len(data):
            raise ValueError(f"zstd: the frame at byte {frame_start} is truncated at byte {pos}")
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        block_at = pos
        pos += 3
        if kind == 3:
            raise ValueError(f"zstd: reserved block type at byte {block_at}")
        stored = 1 if kind == 1 else size
        if pos + stored > len(data):
            raise ValueError(f"zstd: the block at byte {block_at} runs past the input")
        if size > block_max:
            raise ValueError(f"zstd: the block at byte {block_at} is larger than its maximum")
        if kind == 0:
            out += data[pos : pos + size]
        elif kind == 1:
            out += bytes([data[pos]]) * size
        else:
            before = len(out)
            try:
                _block(data, pos, pos + size, out, st)
            except (_Corrupt, IndexError) as e:
                raise ValueError(f"zstd: corrupt compressed block at byte {block_at}: {e}") from None
            if len(out) - before > block_max:
                raise ValueError(f"zstd: the block at byte {block_at} decodes past its maximum")
        pos += stored
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ValueError(
            f"zstd: the frame at byte {frame_start} holds {len(out)} bytes, its header says "
            f"{content_size}"
        )
    if checksum:
        if pos + 4 > len(data):
            raise ValueError(f"zstd: the frame at byte {frame_start} lacks its checksum")
        (want,) = struct.unpack_from("<I", data, pos)
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ValueError(f"zstd: content checksum mismatch in the frame at byte {frame_start}")
        pos += 4
    return bytes(out), pos


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, concatenated (skippable
    frames skipped)."""
    data = memoryview(bytes(data)).cast("B")
    pos = 0
    parts = []
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError(f"zstd: truncated magic number at byte {pos}")
        (magic,) = struct.unpack_from("<I", data, pos)
        if magic == ZSTD_MAGIC:
            try:
                content, pos = _frame(data, pos + 4)
            except IndexError:
                raise ValueError(f"zstd: truncated frame at byte {pos}") from None
            parts.append(content)
        elif magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if pos + 8 > len(data):
                raise ValueError(f"zstd: truncated skippable frame at byte {pos}")
            (size,) = struct.unpack_from("<I", data, pos + 4)
            if pos + 8 + size > len(data):
                raise ValueError(f"zstd: the skippable frame at byte {pos} runs past the input")
            pos += 8 + size
        else:
            raise ValueError(f"zstd: no frame magic at byte {pos} (found {magic:#010x})")
    return b"".join(parts)
