"""ops.score_kernels.score_columns against the JAX package.

On the CPU the wrapper runs its plain version; both it and the JAX
package's scoring are int32 arithmetic, so every field, the emit flag
and the dqstats rows must be equal.  The JAX side is its own
``glf2cns_batch``, ``somatic_score_batch``, ``_device_dqstats`` and the
body of its jitted ``call_batch`` run with the same likelihoods, handed
in where its glfgen would compute them (``call_batch.__wrapped__`` with
``glfgen_batch`` replaced); end to end, the port's ``call_batch`` on
each of the three encodings against the JAX package's, with the JAX
glfgen's likelihoods fed to both.  The inputs are drawn from numpy
seeds: small likelihood ranges that force ties in every scan, depth-0
and padding columns, ``ref16`` 15 and 0, lanes with base code 0, and
``n_keep`` 0, 1 and D.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (SCORE_PAD, f32_tables,  # noqa: E402
                                   port_params, random_raw32, random_u32,
                                   score_inputs, to_packed16)

from somatic_sniper_tpu.models import consensus as jc  # noqa: E402
from somatic_sniper_tpu.models import glfgen as jg  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as tg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.ops import score_kernels as sk  # noqa: E402

CPU = torch.device("cpu")
FIELDS = js.COMPACT_FIELDS
# the consensus fields each sample's glf2cns gives, in ConsensusCall order
CNS = {"tumor": ("tumor_gt", None, "tumor_cnsq", None),
       "normal": ("normal_gt", None, "normal_cnsq", None)}


def _params(use_joint=False, include_loh=True, include_gor=True,
            min_qual=0):
    return T.ModelParams(use_joint_priors=use_joint,
                         somatic_mutation_rate=0.001,
                         min_somatic_qual=min_qual, include_loh=include_loh,
                         include_gor=include_gor)


def _port(cols, ref16, tabs, params, dq=True):
    """score_columns on the CPU over ``score_inputs``' arrays."""
    t = {w: {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)
                                 if v.dtype == np.uint32 else v)
             for k, v in c.items()} for w, c in cols.items()}
    T_, N_ = t["tumor"], t["normal"]
    lanes = (T_["slots"], T_["nk"], N_["slots"], N_["nk"]) if dq else None
    return sk.score_columns(
        T_["lk"], N_["lk"], T_["depth"], N_["depth"], T_["n"], N_["n"],
        torch.from_numpy(ref16), torch.from_numpy(tabs.solo_prior),
        torch.from_numpy(tabs.joint_prior), tabs.q_r_int,
        port_params(params), lanes)


def _jax_call_batch(monkeypatch, tumor, normal, glf, tabs, params, dq):
    """The body of the JAX package's call_batch with ``glf`` ({sample
    batch: (lk, depth)}) in place of its glfgen."""
    def fake_glfgen(cols, *args, **kwargs):
        lk, depth = glf[id(cols)]
        z = jnp.zeros_like(depth)
        return jg.GlfResult(lk=lk, min_lk=z, depth=depth, rms_mapq=z)

    monkeypatch.setattr(js, "glfgen_batch", fake_glfgen)
    fk, coef, lhet = f32_tables(tabs)
    return js.call_batch.__wrapped__(
        tumor, normal, fk, coef, lhet, tabs.solo_prior, tabs.joint_prior,
        tabs.qadd, tabs.q_r_int, precision="fast",
        use_joint=params.use_joint_priors,
        min_somatic_qual=params.min_somatic_qual,
        include_loh=params.include_loh, include_gor=params.include_gor,
        cap_mapq=params.cap_mapq, theta=params.theta, eta=params.eta,
        glf_backend="xla", dq=dq)


def _jax_from_columns(monkeypatch, cols, ref16, tabs, params, dq=True):
    cbs = {w: jg.ColumnBatch(slots=jnp.asarray(c["slots"]),
                             depth=jnp.asarray(c["depth"]),
                             ref16=jnp.asarray(ref16),
                             n_keep=jnp.asarray(c["nk"]))
           for w, c in cols.items()}
    glf = {id(cbs[w]): (jnp.asarray(c["lk"]), jnp.asarray(c["n"]))
           for w, c in cols.items()}
    return _jax_call_batch(monkeypatch, cbs["tumor"], cbs["normal"], glf,
                           tabs, params, dq)


def _assert_scored(got, want):
    """Every field, emit and both dqstats rows equal."""
    np.testing.assert_array_equal(got.emit.numpy(), np.asarray(want.emit),
                                  err_msg="emit")
    assert got.fields.shape == (got.emit.shape[0], len(FIELDS))
    assert got.fields.dtype == torch.int32
    for i, f in enumerate(FIELDS):
        np.testing.assert_array_equal(got.fields[:, i].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for g, w in ((got.tumor_dq, want.tumor_dq),
                 (got.normal_dq, want.normal_dq)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hi", [3, 40, 256])
@pytest.mark.parametrize("use_joint", [False, True])
def test_consensus_matches_glf2cns(hi, use_joint):
    """The consensus fields against the JAX glf2cns_batch on the raw
    depths: the first minimum wins each of the three scans."""
    params = _params(use_joint)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(160, 24, 10 + hi, hi)
    got = _port(cols, ref16, tabs, params, dq=False)
    for who in ("tumor", "normal"):
        c = cols[who]
        want = jc.glf2cns_batch(jnp.asarray(c["lk"]),
                                jnp.asarray(c["depth"]), tabs.q_r_int)
        for name, w in zip(CNS[who], want):
            if name is not None:
                np.testing.assert_array_equal(
                    got.fields[:, FIELDS.index(name)].numpy(),
                    np.asarray(w), err_msg=name)


@pytest.mark.parametrize("hi", [3, 30, 256])
@pytest.mark.parametrize("use_joint", [False, True])
def test_score_matches_somatic_score_batch(hi, use_joint):
    """somatic_score and the joint fields against the JAX
    somatic_score_batch: the qAdd folds in their argument order, the
    100-wide joint argmin (first wins) and the stale-i quirk."""
    params = _params(use_joint)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(192, 16, 20 + hi, hi)
    got = _port(cols, ref16, tabs, params, dq=False)
    want = jc.somatic_score_batch(
        jnp.asarray(cols["tumor"]["lk"]), jnp.asarray(cols["normal"]["lk"]),
        jnp.asarray(ref16), tabs.solo_prior, tabs.joint_prior,
        jc.make_qadd(), use_joint)
    for name, w in zip(("somatic_score", "joint_tumor_gt",
                        "joint_normal_gt", "joint_cnsq"), want):
        np.testing.assert_array_equal(
            got.fields[:, FIELDS.index(name)].numpy(), np.asarray(w),
            err_msg=name)


@pytest.mark.parametrize("D", [1, 48, 255])
def test_dqstats_match_device_dqstats(D):
    """Both dqstats rows against the JAX _device_dqstats with the
    wanted bases of the port's own effective genotypes ('=' lanes count
    toward every base; n_keep 0, 1 and D among the columns)."""
    params = _params()
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(96, D, 30 + D, 60)
    got = _port(cols, ref16, tabs, params)
    f = got.fields.numpy()
    wanted = (ref16 | f[:, FIELDS.index("tumor_eff_gt")]
              | f[:, FIELDS.index("normal_eff_gt")]).astype(np.int32)
    for who, g in (("tumor", got.tumor_dq), ("normal", got.normal_dq)):
        c = cols[who]
        want = js._device_dqstats(jnp.asarray(c["slots"]),
                                  jnp.asarray(c["nk"]), jnp.asarray(ref16),
                                  jnp.asarray(wanted))
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


# the kernel's block (score_columns.cu's kCols) and the depths of its card
# tests: the plain version it is held to, pinned to the JAX package there
SCORE_BLOCK = 64


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [1, 47, 48, 128, 255])
@pytest.mark.parametrize("B", [1, SCORE_BLOCK - 1, SCORE_BLOCK,
                               SCORE_BLOCK + 1, 2 * SCORE_BLOCK + 1])
def test_plain_matches_call_batch_at_block_edges(monkeypatch, B, D,
                                                 use_joint):
    """score_columns_plain (the CPU's route) against the body of the JAX
    call_batch at the B and D of the kernel's card tests: every field,
    emit and both dqstats rows, on tie-heavy likelihoods."""
    params = _params(use_joint, min_qual=15)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(B, D, 3 * B + D + use_joint, 6)
    got = _port(cols, ref16, tabs, params)
    want = _jax_from_columns(monkeypatch, cols, ref16, tabs, params)
    _assert_scored(got, want)


@pytest.mark.parametrize("D", [1, 47, 48])
def test_plain_matches_call_batch_at_65536_columns(monkeypatch, D):
    """The same at the batch path's 65536 columns (solo priors, both
    samples' dqstats).  Deeper lanes at this width take the JAX side
    ~1-2 GB of host memory; the card tests hold the kernel to the plain
    version there."""
    params = _params(min_qual=15)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(65536, D, 65536 + D, 256)
    got = _port(cols, ref16, tabs, params)
    want = _jax_from_columns(monkeypatch, cols, ref16, tabs, params)
    _assert_scored(got, want)
    assert not got.emit[-SCORE_PAD:].any()


@pytest.mark.parametrize("hi", [4, 256])
@pytest.mark.parametrize("include_loh,include_gor",
                         [(True, True), (False, True), (True, False),
                          (False, False)])
@pytest.mark.parametrize("use_joint", [False, True])
def test_matches_call_batch(monkeypatch, use_joint, include_loh,
                            include_gor, hi):
    """Every field, emit and the dqstats rows against the body of the
    JAX call_batch on the same likelihoods, every gate flag each way;
    the padding columns never emit."""
    params = _params(use_joint, include_loh, include_gor, min_qual=15)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(256, 32, 40 + 7 * use_joint + hi, hi)
    got = _port(cols, ref16, tabs, params)
    want = _jax_from_columns(monkeypatch, cols, ref16, tabs, params)
    _assert_scored(got, want)
    assert not got.emit[-SCORE_PAD:].any()


def test_calls_emit_and_filter():
    """The inputs reach every branch the comparisons need: emitted and
    held columns, LOH and GOR filtered only with their flags off."""
    tabs = T.build_tables(_params())
    cols, ref16 = score_inputs(256, 32, 47, 256)
    counts = {}
    for loh, gor in ((True, True), (False, True), (True, False)):
        p = _params(include_loh=loh, include_gor=gor)
        counts[loh, gor] = int(_port(cols, ref16, tabs, p).emit.sum())
    assert 0 < counts[False, True] < counts[True, True]
    assert 0 < counts[True, False] < counts[True, True]


@pytest.mark.parametrize("encoding", ["raw32", "u32", "u16"])
@pytest.mark.parametrize("use_joint", [False, True])
def test_call_batch_matches_jax_on_each_encoding(monkeypatch, encoding,
                                                 use_joint):
    """The port's call_batch (glfgen, then score_columns) against the
    JAX package's jitted call_batch on each encoding, exact: the JAX
    glfgen's likelihoods and depths are handed to the port's scoring, so
    every field, emit and (raw32 only) the dqstats rows must be equal;
    the other encodings carry none."""
    B, D = 192, 40
    params = _params(use_joint)
    tabs = T.build_tables(params)
    pparams = port_params(params)
    dtabs = device_tables(build_tables(pparams), CPU)
    jcb, tcb = {}, {}
    for i, who in enumerate(("tumor", "normal")):
        seed = 60 + i * 1000 + use_joint
        if encoding == "raw32":
            slots, nk, depth, ref16 = random_raw32(B, D, seed)
            jcb[who] = jg.ColumnBatch(jnp.asarray(slots), jnp.asarray(depth),
                                      jnp.asarray(ref16), jnp.asarray(nk))
            tcb[who] = tg.ColumnBatch(torch.from_numpy(slots.view(np.int32)),
                                      torch.from_numpy(depth),
                                      torch.from_numpy(ref16),
                                      torch.from_numpy(nk))
        else:
            slots, depth, ref16 = random_u32(B, D, seed)
            if who == "normal":  # one reference for both samples
                ref16 = np.array(jcb["tumor"].ref16)
            if encoding == "u32":
                jcb[who] = jg.ColumnBatch(jnp.asarray(slots),
                                          jnp.asarray(depth),
                                          jnp.asarray(ref16))
                tcb[who] = tg.ColumnBatch(
                    torch.from_numpy(slots.view(np.int32)),
                    torch.from_numpy(depth), torch.from_numpy(ref16))
            else:
                s16, nk, rms = to_packed16(slots, depth, ref16)
                jcb[who] = jg.ColumnBatch(jnp.asarray(s16),
                                          jnp.asarray(depth),
                                          jnp.asarray(ref16),
                                          jnp.asarray(nk), jnp.asarray(rms))
                tcb[who] = tg.ColumnBatch(
                    torch.from_numpy(s16), torch.from_numpy(depth),
                    torch.from_numpy(ref16), torch.from_numpy(nk),
                    torch.from_numpy(rms))
    if encoding == "raw32":  # one reference for both samples
        jcb["normal"] = jcb["normal"]._replace(ref16=jcb["tumor"].ref16)
        tcb["normal"] = tcb["normal"]._replace(ref16=tcb["tumor"].ref16)
    fk, coef, lhet = f32_tables(tabs)
    glf = {w: jg.glfgen_batch(jcb[w], fk, coef, lhet, precision="fast",
                              cap_mapq=params.cap_mapq, theta=params.theta,
                              eta=params.eta, backend="xla")
           for w in jcb}
    dq = encoding == "raw32"
    want = js.call_batch(
        jcb["tumor"], jcb["normal"], fk, coef, lhet, tabs.solo_prior,
        tabs.joint_prior, tabs.qadd, tabs.q_r_int, precision="fast",
        use_joint=use_joint, min_somatic_qual=params.min_somatic_qual,
        include_loh=params.include_loh, include_gor=params.include_gor,
        cap_mapq=params.cap_mapq, theta=params.theta, eta=params.eta,
        glf_backend="xla", dq=dq)
    fed = iter([glf["tumor"], glf["normal"]])

    def jax_lk(cols, *args):
        g = next(fed)
        return (torch.from_numpy(np.array(g.lk)),
                torch.from_numpy(np.array(g.depth)), None)

    monkeypatch.setattr(ts, "glfgen_lk", jax_lk)
    got = ts.call_batch(tcb["tumor"], tcb["normal"], dtabs, pparams)
    assert int(got.emit.sum()) > B // 8, "too few emitted columns"
    for f in ("emit",) + FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    if dq:
        np.testing.assert_array_equal(got.tumor_dq.numpy(),
                                      np.asarray(want.tumor_dq))
        np.testing.assert_array_equal(got.normal_dq.numpy(),
                                      np.asarray(want.normal_dq))
    else:
        assert got.tumor_dq is None and want.tumor_dq is None


def test_compact_rows_take_the_fields_as_they_come():
    """call_batch_compact (the fields tensor compacted as the kernel
    wrote it) and compact_rows over call_batch's CallResult (the fields
    stacked back) give the same rows."""
    params = _params()
    dtabs = device_tables(build_tables(port_params(params)), CPU)
    cb = []
    for seed in (3, 4):
        slots, nk, depth, ref16 = random_raw32(128, 24, seed)
        cb.append(tg.ColumnBatch(torch.from_numpy(slots.view(np.int32)),
                                 torch.from_numpy(depth),
                                 torch.from_numpy(ref16),
                                 torch.from_numpy(nk)))
    cb[1] = cb[1]._replace(ref16=cb[0].ref16)
    pp = port_params(params)
    a = ts.call_batch_compact(*cb, dtabs, pp, max_emit=128)
    b = ts.compact_rows(ts.call_batch(*cb, dtabs, pp), 128)
    assert int(a.count) == int(b.count) > 0
    assert torch.equal(a.rows, b.rows)


def test_empty_batch():
    params = _params()
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(16, 8, 5, 10)
    cols = {w: {k: v[:0] for k, v in c.items()} for w, c in cols.items()}
    got = _port(cols, ref16[:0], tabs, params)
    assert got.emit.shape == (0,) and got.fields.shape == (0, 16)
    assert got.tumor_dq.shape == (0, 18)


def _args(B=8, D=4):
    tabs = T.build_tables(_params())
    i = torch.zeros((B,), dtype=torch.int32)
    lanes = (torch.zeros((B, D), dtype=torch.int32), i.clone(),
             torch.zeros((B, D), dtype=torch.int32), i.clone())
    return dict(lk_t=torch.zeros((B, 10), dtype=torch.int32),
                lk_n=torch.zeros((B, 10), dtype=torch.int32),
                depth_t=i.clone(), depth_n=i.clone(), n_t=i.clone(),
                n_n=i.clone(), ref16=i.clone(),
                solo_prior=torch.from_numpy(tabs.solo_prior),
                joint_prior=torch.from_numpy(tabs.joint_prior),
                q_r_int=tabs.q_r_int, params=port_params(_params()),
                dq_lanes=lanes)


@pytest.mark.parametrize("name,bad,err", [
    ("lk_t", torch.zeros((8, 10), dtype=torch.int64), TypeError),
    ("lk_n", torch.zeros((8, 10)), TypeError),
    ("ref16", torch.zeros((8,), dtype=torch.int16), TypeError),
    ("lk_n", torch.zeros((8, 9), dtype=torch.int32), ValueError),
    ("depth_t", torch.zeros((7,), dtype=torch.int32), ValueError),
    ("solo_prior", torch.zeros((15, 10), dtype=torch.int32), ValueError),
    ("joint_prior", torch.zeros((16, 10, 9), dtype=torch.int32), ValueError),
    ("lk_t", torch.zeros((8,), dtype=torch.int32), ValueError),
    ("lk_n", torch.zeros((10, 8), dtype=torch.int32).t(), ValueError),
    ("n_n", torch.zeros((8,), dtype=torch.int32, device="meta"),
     ValueError),
    ("dq_lanes", (torch.zeros((8, 4), dtype=torch.int32),), ValueError),
    ("dq_lanes", (torch.zeros((8, 0), dtype=torch.int32),) * 4, ValueError),
])
def test_wrapper_checks_inputs(name, bad, err):
    """dtype, shape, contiguity and device are checked before anything
    runs, and the CPU launches nothing."""
    gk.reset_launches()
    args = _args()
    args[name] = bad
    with pytest.raises(err):
        sk.score_columns(**args)
    assert gk.LAUNCHES["score_columns"] == 0


@pytest.mark.parametrize("part", [0, 1, 2, 3])
def test_wrapper_checks_dq_lanes(part):
    """Each of the four dqstats inputs is checked: dtype and shape."""
    args = _args()
    lanes = list(args["dq_lanes"])
    lanes[part] = lanes[part].to(torch.int64)
    args["dq_lanes"] = tuple(lanes)
    with pytest.raises(TypeError):
        sk.score_columns(**args)
    lanes[part] = lanes[part][:4].to(torch.int32)
    args["dq_lanes"] = tuple(lanes)
    with pytest.raises(ValueError):
        sk.score_columns(**args)


def test_wrapper_refuses_a_device_without_a_kernel():
    """Tensors on a device that is neither the CPU nor a card raise; no
    plain version runs for them."""
    args = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in _args().items() if k != "dq_lanes"}
    with pytest.raises(ValueError, match="unsupported device"):
        sk.score_columns(**args)


def test_cpu_runs_the_plain_version():
    """On the CPU the wrapper's result is the plain version's, and no
    launch is counted."""
    params = _params(True)
    tabs = T.build_tables(params)
    cols, ref16 = score_inputs(64, 16, 9, 20)
    gk.reset_launches()
    got = _port(cols, ref16, tabs, params)
    t = {w: {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                 else v) for k, v in c.items()}
         for w, c in cols.items()}
    want = sk.score_columns_plain(
        t["tumor"]["lk"], t["normal"]["lk"], t["tumor"]["depth"],
        t["normal"]["depth"], t["tumor"]["n"], t["normal"]["n"],
        torch.from_numpy(ref16), torch.from_numpy(tabs.solo_prior),
        torch.from_numpy(tabs.joint_prior), tabs.q_r_int,
        port_params(params), (t["tumor"]["slots"], t["tumor"]["nk"],
                              t["normal"]["slots"], t["normal"]["nk"]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert gk.LAUNCHES["score_columns"] == 0
