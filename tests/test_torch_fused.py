"""The torch port's fused glfgen wrappers (an accumulate and the assembly
in one launch) against the JAX package, and the ctypes binding table
against the C sources.

On the CPU a fused wrapper runs its plain version, the composition of
the accumulate's and the assembly's plain versions.  It is held to
``glfgen_batch(precision="fast", backend="xla")`` of the JAX package on
the same numpy-seeded lanes, in the three encodings.  Tolerance: none at
the depths to 255 of this file (lk, min_lk, depth and rms_mapq are
integers and equal on these inputs); at D = 256 and 300, where sums of
hundreds of f32 terms are taken in another order, an lk may move by one
quantization step, as in tests/test_torch_glfgen.py.
"""

import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (f32_tables, random_raw32,  # noqa: E402
                                   random_u32, to_packed16)

from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.models.glfgen import ColumnBatch as JCB  # noqa: E402
from somatic_sniper_tpu.models.glfgen import glfgen_batch  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as tg  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    device_tables, fk_weights_f32)
from somatic_sniper_tpu_torch.ops import build  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402

CPU = torch.device("cpu")
ENCODINGS = ["raw32", "u16", "u32"]
FUSED = {"raw32": "glfgen32", "u16": "glfgen16", "u32": "glfgen_u32"}
# raw kept-only lanes deeper than 255 (a deep slab) take the full-word
# accumulate with n_keep as the depth: they hold no deletion
TWO_STEP = {"raw32": "accumulate", "u16": "accumulate16",
            "u32": "accumulate"}


def _batches(encoding, B, D, seed):
    """The same columns as a JAX ColumnBatch and as the port's."""
    if encoding == "raw32":
        slots, nk, _, ref16 = random_raw32(B, D, seed)
        jcb = JCB(slots=jnp.asarray(slots), depth=jnp.asarray(nk),
                  ref16=jnp.asarray(ref16), n_keep=jnp.asarray(nk))
        tcb = tg.ColumnBatch(slots=torch.from_numpy(slots.view(np.int32)),
                             depth=torch.from_numpy(nk),
                             ref16=torch.from_numpy(ref16),
                             n_keep=torch.from_numpy(nk))
        return jcb, tcb
    slots, depth, ref16 = random_u32(B, D, seed)
    depth[0] = D  # one full column
    if encoding == "u16":
        s16, nk, rms = to_packed16(slots, depth, ref16)
        jcb = JCB(slots=jnp.asarray(s16), depth=jnp.asarray(depth),
                  ref16=jnp.asarray(ref16), n_keep=jnp.asarray(nk),
                  rms_sum=jnp.asarray(rms))
        tcb = tg.ColumnBatch(
            slots=torch.from_numpy(s16), depth=torch.from_numpy(depth),
            ref16=torch.from_numpy(ref16), n_keep=torch.from_numpy(nk),
            rms_sum=torch.from_numpy(rms))
        return jcb, tcb
    jcb = JCB(slots=jnp.asarray(slots), depth=jnp.asarray(depth),
              ref16=jnp.asarray(ref16))
    tcb = tg.ColumnBatch(slots=torch.from_numpy(slots.view(np.int32)),
                         depth=torch.from_numpy(depth),
                         ref16=torch.from_numpy(ref16))
    return jcb, tcb


def _fused_call(encoding, tcb, dtabs):
    """(lk, min_lk) of the encoding's fused wrapper, called directly."""
    D = tcb.slots.shape[1]
    w, (coef_sub, lhet_sub) = dtabs.fk_weights, dtabs.assembly_tables(D)
    if encoding == "raw32":
        return gk.glfgen32(tcb.slots, tcb.n_keep, tcb.ref16, w, coef_sub,
                           lhet_sub, 60)[:2]
    if encoding == "u16":
        return gk.glfgen16(tcb.slots, tcb.n_keep, w, coef_sub, lhet_sub)
    return gk.glfgen_u32(tcb.slots, tcb.depth, tcb.ref16, w, coef_sub,
                         lhet_sub, 60)[:2]


def _spy(monkeypatch):
    """Records which kernel wrappers glfgen_batch calls."""
    called = []
    for name in dict.fromkeys((*FUSED.values(), *TWO_STEP.values(),
                               "assembly10_flagged")):
        def wrapped(*args, _fn=getattr(tg, name), _name=name):
            called.append(_name)
            return _fn(*args)
        monkeypatch.setattr(tg, name, wrapped)
    return called


@pytest.mark.parametrize("D", [1, 31, 33, 48, 255])
@pytest.mark.parametrize("encoding", ENCODINGS)
def test_fused_wrappers_match_xla(encoding, D, monkeypatch):
    """To depth 255 glfgen_batch is the encoding's fused wrapper alone,
    and its results equal the JAX package's XLA fast path."""
    B = 24 if D == 255 else 96
    jcb, tcb = _batches(encoding, B, D, seed=100 + D)
    tabs = T.build_tables(T.ModelParams())
    fk, coef, lhet = f32_tables(tabs)
    want = glfgen_batch(jcb, fk, coef, lhet, precision="fast", backend="xla")
    dtabs = device_tables(tabs, CPU)
    called = _spy(monkeypatch)
    got = tg.glfgen_batch(tcb, dtabs, 60)
    assert called == [FUSED[encoding]]
    np.testing.assert_array_equal(got.lk.numpy(), np.asarray(want.lk))
    np.testing.assert_array_equal(got.min_lk.numpy(), np.asarray(want.min_lk))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.rms_mapq.numpy(),
                                  np.asarray(want.rms_mapq))
    lk, min_lk = _fused_call(encoding, tcb, dtabs)
    assert torch.equal(lk, got.lk) and torch.equal(min_lk, got.min_lk)


@pytest.mark.parametrize("D", [256, 300])
@pytest.mark.parametrize("encoding", ["u16", "u32"])
def test_glfgen_batch_two_step_above_255(encoding, D, monkeypatch):
    """Deeper batches take the accumulate, the c_tot > 255 rescale and
    assembly10 with its error word left on the device
    (``assembly10_flagged``, 0 here), and still match the XLA fast
    path."""
    jcb, tcb = _batches(encoding, 32, D, seed=D)
    tabs = T.build_tables(T.ModelParams())
    fk, coef, lhet = f32_tables(tabs)
    want = glfgen_batch(jcb, fk, coef, lhet, precision="fast", backend="xla")
    called = _spy(monkeypatch)
    got = tg.glfgen_batch(tcb, device_tables(tabs, CPU), 60)
    assert called == [TWO_STEP[encoding], "assembly10_flagged"]
    assert got.err.dtype == torch.int32 and got.err.tolist() == [0]
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.rms_mapq.numpy(),
                                  np.asarray(want.rms_mapq))
    for a, b in ((got.lk, want.lk), (got.min_lk, want.min_lk)):
        d = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
        assert d.max() <= 1
        assert (d.reshape(len(d), -1) == 0).all(axis=1).mean() >= 0.9


def _fused_args(encoding, B=8, D=16):
    """Good CPU arguments of the encoding's fused wrapper, as a dict in
    call order."""
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    nk1 = D + 1
    i32 = torch.zeros(B, dtype=torch.int32)
    tables = dict(coef_sub=torch.zeros((60, nk1, nk1)),
                  lhet_sub=torch.zeros((nk1, nk1)))
    if encoding == "u16":
        return dict(slots=torch.zeros((B, D), dtype=torch.uint16),
                    n_keep=i32, weights=w, **tables)
    return dict(slots=torch.zeros((B, D), dtype=torch.int32), n_keep=i32,
                ref16=i32, weights=w, **tables, cap_mapq=60)


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_fused_wrappers_check_inputs(encoding):
    fn = getattr(gk, FUSED[encoding])
    good = _fused_args(encoding)
    lk, min_lk = fn(*good.values())[:2]
    assert lk.shape == (8, 10) and min_lk.shape == (8,)
    assert int(lk.abs().max()) == 0  # empty columns are all-zero

    def call(**changed):
        return fn(*{**good, **changed}.values())

    with pytest.raises(TypeError):  # lanes of another type
        call(slots=good["slots"].to(torch.int64))
    with pytest.raises(ValueError):  # not [B, D]
        call(slots=good["slots"][0])
    with pytest.raises(ValueError):  # not contiguous
        call(slots=good["slots"][:, ::2])
    with pytest.raises(ValueError):  # n_keep of another length
        call(n_keep=good["n_keep"][:3])
    with pytest.raises(ValueError):  # a tensor on another device
        call(n_keep=good["n_keep"].to("meta"))
    with pytest.raises(TypeError):  # weights must be f32
        call(weights=good["weights"].double())
    with pytest.raises(ValueError):  # tables shallower than the batch
        call(coef_sub=torch.zeros((60, 16, 16)),
             lhet_sub=torch.zeros((16, 16)))
    with pytest.raises(ValueError):  # lhet of another depth than coef
        call(lhet_sub=torch.zeros((16, 16)))
    deep = _fused_args(encoding, D=256)  # past 255: the two-step route
    deep.update(coef_sub=torch.zeros((60, 256, 256)),
                lhet_sub=torch.zeros((256, 256)))
    with pytest.raises(ValueError, match="255"):
        fn(*deep.values())
    assert set(gk.LAUNCHES.values()) == {0}


def test_launch_counters_have_the_fused_keys():
    assert set(gk.LAUNCHES) == {"accumulate32", "accumulate", "accumulate16",
                                "assembly10", "glfgen32", "glfgen",
                                "glfgen16", "score_columns"}
    jcb, tcb = _batches("u32", 16, 8, seed=1)
    tg.glfgen_batch(tcb, device_tables(T.build_tables(T.ModelParams()), CPU))
    assert set(gk.LAUNCHES.values()) == {0}  # the CPU launches nothing
    gk.LAUNCHES["glfgen"] += 1
    gk.reset_launches()
    assert set(gk.LAUNCHES.values()) == {0}


def test_assembly10_launch_needs_the_card():
    """The launch without the wait has no plain version behind it."""
    e = torch.zeros((4, 4))
    c = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        gk.assembly10_launch(e, e, c, c[:, 0].contiguous(),
                             torch.zeros((60, 17, 17)),
                             torch.zeros((17, 17)))


# -- the ctypes table against the C sources ---------------------------------

_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "double": ctypes.c_double, "const char*": ctypes.c_char_p,
            "void": None}
_EXTERN_C = re.compile(
    r'extern\s+"C"\s+(?P<ret>[\w\s]+?\*?)\s*(?P<name>sniper_\w+)\s*'
    r'\((?P<args>[^)]*)\)\s*\{')


def _c_functions():
    """{name: ([argument ctypes], result ctype)} of every extern "C"
    sniper_* function defined under csrc/."""
    found = {}
    for src in build.sources():
        for m in _EXTERN_C.finditer(src.read_text()):
            args = [" ".join(a.split()).rsplit(" ", 1)[0]
                    for a in m["args"].split(",") if a.strip()]
            found[m["name"]] = ([_C_TYPES[a] for a in args],
                                _C_TYPES[" ".join(m["ret"].split())])
    return found


def test_every_c_function_is_bound():
    assert set(_c_functions()) == set(build.SIGNATURES)
    assert len(build.SIGNATURES) == 16


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_binding_matches_c_signature(name):
    """A wrong ctypes arity or width corrupts memory silently: the
    table's argument count, each argument's type and the result type
    equal the C definition's."""
    argtypes, restype = build.SIGNATURES[name]
    c_args, c_ret = _c_functions()[name]
    assert len(argtypes) == len(c_args)
    assert list(argtypes) == c_args
    assert restype is c_ret


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_120score_columns_kernelILb0ELb0EEEvNS_9ScoreArgsE",
     "score_columns_kernel<0,0>"),
    ("_ZN12_GLOBAL__N_120score_columns_kernelILb0ELb1EEEvNS_9ScoreArgsE",
     "score_columns_kernel<0,1>"),
    ("_ZN12_GLOBAL__N_120score_columns_kernelILb1ELb0EEEvNS_9ScoreArgsE",
     "score_columns_kernel<1,0>"),
    ("_ZN12_GLOBAL__N_120score_columns_kernelILb1ELb1EEEvNS_9ScoreArgsE",
     "score_columns_kernel<1,1>"),
    ("_ZN12_GLOBAL__N_119accumulate32_kernelILi64EEEvPKiS2_S2_PKfPfS5_PiS6_iii",
     "accumulate32_kernel<64>"),
    ("_ZN12_GLOBAL__N_115glfgen16_kernelILi256EEEvPKtPKiPKfS6_S6_PiS7_iii",
     "glfgen16_kernel<256>"),
    ("_ZN12_GLOBAL__N_117accumulate_kernelILi0EEEvPKiS2_S2_PKfPfS5_PiS6_S6_S6_"
     "iiiibi", "accumulate_kernel<0>"),
    ("_ZN12_GLOBAL__N_117accumulate_kernelILin1EEEvPKi",
     "accumulate_kernel<-1>"),
    ("_ZN12_GLOBAL__N_117assembly10_kernelEPKfS1_PKiS3_S1_S1_PiS4_S4_ii",
     "assembly10_kernel"),
    ("_Z12empty_kernelv", "empty_kernel"),
    ("_ZN7cub_ns6detail5helperEv", None),
])
def test_kernel_names_from_mangled_symbols(mangled, name):
    """resource_usage's names: each template instance its own (four of
    score_columns_kernel, told apart by their two bools), one int
    argument as <N>, a plain kernel bare, and no name for a symbol that
    is not a *_kernel."""
    assert build._kernel_of(mangled) == name
