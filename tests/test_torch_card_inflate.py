"""The card's BGZF inflate (``ops/csrc/bgzf_inflate.cu``) and the native
loader's hand-off to it (``sniper_set_card_inflate``).

On every machine:
- the kernel's decoder, ``ops/csrc/bgzf_inflate.cuh``, compiled for the
  host under a warp emulation (``tests/bgzf_warp_emul.cpp``: 32 lanes as
  fibers that switch at every barrier), byte-equal to zlib on every kind
  of stream (``tests/inflate_cases.py``), refusing what zlib refuses;
- the native loader with a registered test inflater made of zlib (a
  ctypes callback with the card's contract): every block of a region of
  16 blocks or more goes to it in one call, a smaller region stays on the
  host, a block it refuses is inflated again on the host, the pileups and
  errors are those of the unregistered loader, a call that fails as a
  whole fails its load, and a CPU run of the windowed driver registers
  nothing.

Marked ``cuda`` (each skips without a card), on a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_card_inflate.py
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from tests import inflate_cases as ic

pytest.importorskip("torch")

from somatic_sniper_tpu_torch.io import bai, native, native_api  # noqa: E402
from somatic_sniper_tpu_torch.io.bam import read_bam_header  # noqa: E402
from somatic_sniper_tpu_torch.parallel.sharded import (  # noqa: E402
    call_pair_windows, genome_windows)

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CSRC = REPO / "somatic_sniper_tpu_torch" / "ops" / "csrc"
SIM1 = HERE / "data" / "e2e" / "sim1"
# the test pair's windows: ~28 blocks a sample, past the loader's 16
WINDOW = 50_000
# bgzf::Status
OK, BAD_STREAM, BAD_LENGTH, BAD_CRC, OVERRUN, TOO_LARGE = range(6)


# -- the kernel's decoder under the warp emulation ---------------------------

@pytest.fixture(scope="module")
def emul(tmp_path_factory):
    """emul(stream, isize, crc) -> (status, output) through the kernel's
    own source; checks that nothing is written past ISIZE rounded up to
    16 and that the lanes passed the same barriers."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = tmp_path_factory.mktemp("emul") / "bgzf_warp_emul.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I",
                    str(CSRC), "-o", str(so),
                    str(HERE / "bgzf_warp_emul.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.emul_inflate.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_uint]
    lib.emul_inflate.restype = ctypes.c_int

    def run(stream: bytes, isize: int, crc: int):
        inb = np.zeros(max(4, -(-len(stream) // 4) * 4), np.uint8)
        inb[:len(stream)] = np.frombuffer(stream, np.uint8)
        room = -(-max(isize, 0) // 16) * 16
        out = np.full(room + 64, 0x5A, np.uint8)
        st = lib.emul_inflate(inb.ctypes.data, len(stream), out.ctypes.data,
                              isize, crc)
        assert st >= 0, "the lanes passed different barriers"
        assert (out[room:] == 0x5A).all(), "written past the block's room"
        return st, out[:max(isize, 0)].tobytes()

    return run


@pytest.fixture(scope="module")
def cases():
    return ic.cases()


@pytest.mark.parametrize("name", ic.NAMES)
def test_emulated_kernel_equals_zlib(emul, cases, name):
    stream, data = cases[name]
    st, got = emul(stream, len(data), zlib.crc32(data))
    assert st == OK and got == data


def test_emulated_kernel_every_block_of_the_bams(emul):
    n = 0
    for bam in (SIM1 / "tumor.bam", SIM1 / "normal.bam",
                HERE / "data" / "t-small.bam", HERE / "data" / "n-small.bam"):
        for stream, isize, crc in ic.bgzf_blocks(bam):
            st, got = emul(stream, isize, crc)
            assert st == OK and got == zlib.decompress(stream, -15)
            n += 1
    assert n > 10


def _damaged_verdicts(run, cases):
    """For one-bit flips and truncations of four kinds of stream: a stream
    zlib inflates gives zlib's bytes (held to their own CRC, so that the
    CRC hides no difference), one it refuses is refused; and with the
    block's own CRC a stream zlib inflates to other bytes is refused as a
    CRC mismatch."""
    seen = set()
    for k, name in enumerate(("dynamic", "fixed", "mixed", "stored")):
        stream, data = cases[name]
        for bad in ic.damaged(stream, 16, seed=k):
            want = ic.zlib_inflate(bad, len(data))
            if want is None:
                st, _ = run(bad, len(data), zlib.crc32(data))
                assert st != OK, name
                seen.add("refused")
                continue
            st, got = run(bad, len(data), zlib.crc32(want))
            assert st == OK and got == want, name
            st, _ = run(bad, len(data), zlib.crc32(data))
            assert st == (OK if want == data else BAD_CRC), name
            seen.add("crc" if want != data else "same")
    assert {"refused", "crc"} <= seen


def test_emulated_kernel_refuses_what_zlib_refuses(emul, cases):
    _damaged_verdicts(emul, cases)


def test_emulated_kernel_holds_the_output_to_crc_and_isize(emul, cases):
    stream, data = cases["dynamic"]
    crc = zlib.crc32(data)
    assert emul(stream, len(data), crc ^ 1)[0] == BAD_CRC
    assert emul(stream, len(data) - 1, crc)[0] == BAD_LENGTH
    assert emul(stream, len(data) + 1, crc)[0] == BAD_LENGTH
    assert emul(stream, 65537, crc)[0] == TOO_LARGE
    assert emul(stream[:-1], len(data), crc)[0] != OK


# -- the native loader's hand-off, with a test inflater made of zlib --------

CARD_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int,
                           *([ctypes.c_void_p] * 7))


def _array(p, ctype, n):
    return np.ctypeslib.as_array(ctypes.cast(p, ctypes.POINTER(ctype)), (n,))


class ZlibInflater:
    """A card inflater with the card's contract, made of zlib: a block
    whose output misses its ISIZE or CRC32 comes back refused.  ``corrupt``
    spoils the output of the block with that running number; ``rc``
    fails every call."""

    def __init__(self, corrupt: int | None = None, rc: int = 0):
        self.blocks, self.calls, self.corrupt, self.rc = 0, 0, corrupt, rc
        self.fn = CARD_FN(self._call)
        self.address = ctypes.cast(self.fn, ctypes.c_void_p).value

    def _call(self, device, comp, comp_len, n, in_off, in_len, isize, crc,
              out, out_off, status):
        self.calls += 1
        io, oo = (_array(p, ctypes.c_int64, n) for p in (in_off, out_off))
        il, sz, st = (_array(p, ctypes.c_int32, n)
                      for p in (in_len, isize, status))
        cr = _array(crc, ctypes.c_uint32, n)
        for i in range(n):
            try:
                data = zlib.decompress(ctypes.string_at(comp + int(io[i]),
                                                        int(il[i])), -15)
            except zlib.error:
                data = None
            if data and self.blocks == self.corrupt:
                data = bytes([data[0] ^ 0xFF]) + data[1:]
            self.blocks += 1
            ok = (data is not None and len(data) == sz[i]
                  and zlib.crc32(data) == cr[i])
            st[i] = OK if ok else BAD_CRC
            if ok:
                ctypes.memmove(out + int(oo[i]), data, len(data))
        return self.rc


@contextlib.contextmanager
def registered(address, device=0):
    native.set_card_inflate(address, device)
    try:
        yield
    finally:
        native.set_card_inflate(None)


def _lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("needs the native host library (g++ and zlib)")
    return lib


def _counts():
    return native.load_counters(_lib())[1]


def _load_all(bam, window=WINDOW):
    """Every window's region pileup of ``bam`` (copied out of the native
    memory), or the error that window's load raised."""
    header = read_bam_header(str(bam))
    idx = bai.ensure_index(str(bam))
    out = []
    for tid, beg, end in genome_windows(header.ref_lengths, window):
        ch = np.asarray(bai.region_chunks(idx, tid, beg, end),
                        np.int64).reshape(-1, 2)
        try:
            pu = native_api.load_region_and_columnize(str(bam), ch, tid, beg,
                                                      end)
            out.append(tuple(np.array(a) for a in
                             (pu.keys, pu.slots, pu.ukeys, pu.offsets)))
        except OSError as e:
            out.append(str(e))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, str) or isinstance(y, str):
            assert x == y
        else:
            assert all(u.dtype == v.dtype and np.array_equal(u, v)
                       for u, v in zip(x, y))


def _delta(c0, c1):
    return {k.split(".", 1)[1]: c1[k] - c0[k] for k in c0}


def _loaded_with(address, bam, window=WINDOW, device=0):
    c0 = _counts()
    with registered(address, device):
        got = _load_all(bam, window)
    return got, _delta(c0, _counts())


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 2 x 100 kb pair at 20x from the benchmark's generator (its BGZF
    blocks: 65,280 bytes of records at zlib level 1)."""
    # the generator's worker processes import it by the same path
    sys.path.insert(0, str(REPO / "benchmark"))
    import pairgen

    cfg = {"n_contigs": 2, "contig_len": 100_000, "read_len": 150,
           "tumor_depth": 20.0, "normal_depth": 20.0, "somatic_rate": 1e-3,
           "germline_rate": 1e-2, "error_rate": 0.005, "baseq_lo": 15,
           "baseq_hi": 40}
    return pairgen.generate(tmp_path_factory.mktemp("pair"), cfg, 2**31 + 16,
                            workers=1)


def test_registered_inflater_takes_every_region_block(pair):
    _lib()
    for bam in (pair.tumor, pair.normal):
        c0 = _counts()
        want = _load_all(bam)
        host = _delta(c0, _counts())
        n = host["blocks_libdeflate"] + host["blocks_zlib"]
        assert n > 0 and host["blocks_card"] == host["blocks_card_redo"] == 0
        inf = ZlibInflater()
        got, d = _loaded_with(inf.address, bam)
        _same(want, got)
        assert d["blocks_card"] == inf.blocks == n
        assert d["blocks_card_redo"] == 0
        assert d["blocks_libdeflate"] + d["blocks_zlib"] == 0
        assert d["bytes_inflated"] == host["bytes_inflated"]
        # one call a region: every chunk's blocks together
        assert inf.calls == len(want)


def test_small_regions_stay_on_the_host():
    """sim1's 1 kb windows hold fewer than 16 blocks each: a card call
    would wait longer than zlib takes, so the host inflates them."""
    _lib()
    want = _load_all(SIM1 / "tumor.bam", 1000)
    inf = ZlibInflater()
    got, d = _loaded_with(inf.address, SIM1 / "tumor.bam", 1000)
    _same(want, got)
    assert inf.calls == 0 and d["blocks_card"] == 0
    assert d["blocks_libdeflate"] + d["blocks_zlib"] > 0


def test_refused_block_is_inflated_again_on_the_host(pair):
    _lib()
    want = _load_all(pair.tumor)
    inf = ZlibInflater(corrupt=1)
    got, d = _loaded_with(inf.address, pair.tumor)
    _same(want, got)
    assert d["blocks_card_redo"] == 1
    assert d["blocks_libdeflate"] + d["blocks_zlib"] == 1
    assert d["blocks_card"] == inf.blocks


def test_failed_call_fails_the_load(pair):
    """A call that fails as a whole (a CUDA error) fails its region load,
    as a failed host inflate does; no block is inflated again on the host
    and none is counted as the card's.  A window of fewer than 16 blocks
    makes no call and loads as without a card."""
    _lib()
    want = _load_all(pair.normal)
    inf = ZlibInflater(rc=2)
    got, d = _loaded_with(inf.address, pair.normal)
    assert len(got) == len(want)
    failed = [g for g in got if isinstance(g, str)]
    assert inf.calls == len(failed) > 0
    assert all(g.endswith("BGZF inflate failure (region, card: CUDA error "
                          "2)") for g in failed)
    _same([w for w, g in zip(want, got) if not isinstance(g, str)],
          [g for g in got if not isinstance(g, str)])
    assert d["blocks_card"] == d["blocks_card_redo"] == 0


def _spoiled_copies(bam, tmp_path, n=6):
    """Copies of ``bam`` (and its index), each with one bit of its third
    block's DEFLATE stream flipped (the first holds the header)."""
    raw = Path(bam).read_bytes()
    start = sum(18 + len(s) + 8 for s, _, _ in ic.bgzf_blocks(bam)[:2]) + 18
    rng = np.random.default_rng(5)
    out = []
    for k, bit in enumerate(rng.choice(8 * 20000, n, replace=False)):
        b = bytearray(raw)
        b[start + bit // 8] ^= 1 << (bit % 8)
        p = tmp_path / f"spoiled{k}.bam"
        p.write_bytes(bytes(b))
        shutil.copy(f"{bam}.bai", tmp_path / f"spoiled{k}.bam.bai")
        out.append(p)
    return out


def test_spoiled_block_fails_or_loads_as_without_a_card(pair, tmp_path):
    """The card refuses the spoiled block (zlib's verdict or a CRC32
    mismatch), the host inflates it again, and every window ends as it
    does without a card: the same pileup, or the same error."""
    _lib()
    errors = 0
    for bam in _spoiled_copies(pair.tumor, tmp_path):
        want = _load_all(bam)
        got, d = _loaded_with(ZlibInflater().address, bam)
        _same(want, got)
        assert d["blocks_card_redo"] >= 1  # each load holding the block
        errors += sum(isinstance(w, str) for w in want)
    assert errors > 0


def test_a_cpu_run_registers_no_card_inflater(pair):
    """The windowed driver clears a registration unless its device is a
    card: a CPU run inflates every block on the host."""
    _lib()
    inf = ZlibInflater()
    native.set_card_inflate(inf.address, 0)
    try:
        c0 = _counts()
        lines = []
        for _wi, _w, ls in call_pair_windows(
                str(pair.tumor), str(pair.normal), str(pair.ref), fmt="vcf",
                precision="fast", window_size=WINDOW, device="cpu"):
            lines.extend(ls)
        d = _delta(c0, _counts())
    finally:
        native.set_card_inflate(None)
    assert lines and inf.calls == 0
    assert d["blocks_card"] == d["blocks_card_redo"] == 0
    assert d["blocks_libdeflate"] + d["blocks_zlib"] > 0


# -- the kernel on the card --------------------------------------------------

@pytest.fixture
def card():
    """(kernels' library, device index); skips without a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    from somatic_sniper_tpu_torch.ops import build

    return build.load_library(), torch.cuda.current_device()


def card_inflate(card, blocks):
    """``sniper_card_inflate`` on host buffers: (rc, statuses, outputs)
    for [(stream, isize, crc)]."""
    lib, device = card
    n = len(blocks)
    comp = np.frombuffer(b"".join(s for s, _, _ in blocks) or b"\0", np.uint8)
    in_len = np.array([len(s) for s, _, _ in blocks], np.int32)
    in_off = np.concatenate(([0], np.cumsum(in_len)[:-1])).astype(np.int64)
    isize = np.array([i for _, i, _ in blocks], np.int32)
    out_off = np.concatenate(([0], np.cumsum(np.maximum(isize, 0))[:-1])
                             ).astype(np.int64)
    crc = np.array([c for _, _, c in blocks], np.uint32)
    out = np.zeros(max(1, int(np.maximum(isize, 0).sum())), np.uint8)
    status = np.full(n, -1, np.int32)
    rc = lib.sniper_card_inflate(
        device, comp.ctypes.data, len(comp), n, in_off.ctypes.data,
        in_len.ctypes.data, isize.ctypes.data, crc.ctypes.data,
        out.ctypes.data, out_off.ctypes.data, status.ctypes.data)
    outs = [out[o:o + max(s, 0)].tobytes() for o, s in zip(out_off, isize)]
    return rc, status, outs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ic.NAMES)
def test_card_kernel_equals_zlib(card, cases, name):
    stream, data = cases[name]
    rc, st, outs = card_inflate(card, [(stream, len(data), zlib.crc32(data))])
    assert rc == 0 and st[0] == OK and outs[0] == data


@pytest.mark.cuda
def test_card_kernel_every_block_of_a_pair(card, pair):
    """Every block of both BAMs of a pair, twice over in one call (two
    batches of at most 256), byte-equal to zlib."""
    blocks = [b for bam in (pair.tumor, pair.normal)
              for b in ic.bgzf_blocks(bam)] * 2
    assert len(blocks) > 256
    rc, st, outs = card_inflate(card, blocks)
    assert rc == 0 and (st == OK).all()
    for (stream, isize, _), got in zip(blocks, outs):
        assert got == zlib.decompress(stream, -15)


@pytest.mark.cuda
def test_card_kernel_refuses_what_zlib_refuses(card, cases):
    def run(stream, isize, crc):
        rc, st, outs = card_inflate(card, [(stream, isize, crc)])
        assert rc == 0
        return int(st[0]), outs[0]

    _damaged_verdicts(run, cases)
    stream, data = cases["dynamic"]
    crc = zlib.crc32(data)
    assert run(stream, len(data), crc ^ 1)[0] == BAD_CRC
    assert run(stream, len(data) + 1, crc)[0] == BAD_LENGTH
    assert run(stream, 65537, crc)[0] == TOO_LARGE


@pytest.mark.cuda
def test_card_kernel_every_case_in_one_call(card, cases):
    """Every case in one call: one launch, counted where it is made."""
    lib = card[0]
    blocks = [(cases[k][0], len(cases[k][1]), zlib.crc32(cases[k][1]))
              for k in ic.NAMES]
    n0 = lib.sniper_bgzf_inflate_launches()
    rc, st, outs = card_inflate(card, blocks)
    assert rc == 0 and (st == OK).all()
    assert lib.sniper_bgzf_inflate_launches() - n0 == 1
    assert outs == [cases[k][1] for k in ic.NAMES]


_POISONED = """
import ctypes, sys
import numpy as np
from somatic_sniper_tpu_torch.ops import build
lib = build.load_library()
comp = np.zeros(64, np.uint8)
z64 = np.zeros(1, np.int64)
z32 = np.zeros(1, np.int32)
st = np.full(1, -1, np.int32)
out = np.zeros(16, np.uint8)
def call(device):
    return lib.sniper_card_inflate(
        device, comp.ctypes.data, 64, 1, z64.ctypes.data, z32.ctypes.data,
        z32.ctypes.data, z32.ctypes.data, out.ctypes.data, z64.ctypes.data,
        st.ctypes.data)
print(call(int(sys.argv[1])), call(0), lib.sniper_bgzf_inflate_launches())
"""


@pytest.mark.cuda
def test_card_error_ends_the_cards_part(card):
    """A CUDA error (here a device that does not exist) fails that call and
    every later one, which stage and launch nothing."""
    import torch

    r = subprocess.run(
        [sys.executable, "-c", _POISONED, str(torch.cuda.device_count())],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    first, later, launches = map(int, r.stdout.split())
    assert first != 0 and later == first and launches == 0


def _card_address():
    from somatic_sniper_tpu_torch.ops import build

    return build.card_inflate_address()


@pytest.mark.cuda
def test_card_region_loads_equal_host_loads(card, pair):
    for bam in (pair.tumor, pair.normal):
        c0 = _counts()
        want = _load_all(bam)
        host = _delta(c0, _counts())
        got, d = _loaded_with(_card_address(), bam, device=card[1])
        _same(want, got)
        n = host["blocks_libdeflate"] + host["blocks_zlib"]
        assert d["blocks_card"] == n > 0 and d["blocks_card_redo"] == 0
        assert d["blocks_libdeflate"] + d["blocks_zlib"] == 0


@pytest.mark.cuda
def test_card_spoiled_block_fails_or_loads_as_without_a_card(card, pair,
                                                            tmp_path):
    for bam in _spoiled_copies(pair.tumor, tmp_path):
        want = _load_all(bam)
        got, d = _loaded_with(_card_address(), bam, device=card[1])
        _same(want, got)
        assert d["blocks_card_redo"] >= 1  # each load holding the block


_FIRST_PASS = """
import hashlib, sys
from somatic_sniper_tpu_torch.parallel import sharded
from somatic_sniper_tpu_torch.utils.stats import STATS
if sys.argv[4] == "host":
    sharded._card_inflate_on = lambda dev: dev
lines = []
for _wi, _w, ls in sharded.call_pair_windows(
        sys.argv[1], sys.argv[2], sys.argv[3], fmt="vcf", precision="fast",
        window_size=50000, device="cuda"):
    lines.extend(ls)
s = STATS.snapshot()
print(hashlib.sha256("".join(lines).encode()).hexdigest(), len(lines),
      *(int(s.get(k, 0)) for k in ("native.blocks_card", "slabs_dispatched",
                                    "slabs_graphed")))
"""


@pytest.mark.cuda
def test_card_first_pass_captures_while_the_pool_inflates(card, pair):
    """A fresh process's first pass, where the slab steps are captured on
    the device thread while the pool threads inflate on the card: the same
    bytes as the same pass inflated on the host."""
    run = []
    for mode in ("card", "host"):
        r = subprocess.run(
            [sys.executable, "-c", _FIRST_PASS, str(pair.tumor),
             str(pair.normal), str(pair.ref), mode],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env={**os.environ, "SNIPER_LOAD_POOL": "6"})
        assert r.returncode == 0, r.stderr[-3000:]
        run.append(r.stdout.split())
    (sha, n, blocks, slabs, graphed), host = run[0], run[1]
    assert [sha, n] == host[:2] and int(n) > 0
    assert int(blocks) > 0 and host[2] == "0"
    assert int(graphed) > 0 and int(slabs) > 0
