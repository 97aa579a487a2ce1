"""The port's AOT serving artifacts (stvd_torch/export_aot.py) against the
live Captioner and against the JAX package's artifacts.

Mirrors tests/test_export_aot.py at its tiny float32 config, with the
JAX package's ``init_params(PRNGKey(0))`` weights carried over as numpy.
CPU-platform artifacts must reproduce the live port Captioner token for
token (both run the same torch ops) and the JAX package's CPU artifact
on the same weights and features.  A CUDA-platform export runs here too,
traced on fake tensors: its saved graph must hold the kernels' custom
ops, and no kernel runs.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from stvd import export_aot as jexport
from stvd.api import Captioner as JCaptioner
from stvd.config import Config, DecodeConfig
from stvd.data.text import Vocab
from stvd.model.decoder import init_params
from stvd_torch import export_aot
from stvd_torch.api import Captioner, pack_request
from stvd_torch.model import kernel

from conftest import small_cfg
from test_torch_step import numpy_params

MCFG = small_cfg()
VOCAB = Vocab({f"w{i}": i for i in range(2, MCFG.n_words)})
KERNELS = ("attention_core", "logit_tail", "spatial_core", "gates_lstm")


def weights(m=MCFG, seed=0):
    """The JAX package's init_params as float32 numpy arrays."""
    return {k: np.asarray(v, np.float32)
            for k, v in init_params(jax.random.PRNGKey(seed), m).items()}


def config(m=MCFG, beam=2, batch=2, maxlen=8):
    return Config(model=m, decode=DecodeConfig(beam_size=beam, maxlen=maxlen,
                                               decode_batch=batch))


def feats_for(n, m=MCFG, seed=0, spatial=False, motion=False):
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, m.n_frames, m.ctx_dim).astype(np.float32)
    regs = (list(rng.randn(n, m.n_frames, m.n_regions, m.region_dim)
                 .astype(np.float32)) if spatial else None)
    mots = (list(rng.randn(n, m.n_frames, m.motion_dim)
                 .astype(np.float32)) if motion else None)
    return feats, regs, mots


def save(tmp_path, params, cfg, name="artifact", **kw):
    out = str(tmp_path / name)
    kw.setdefault("platforms", ("cpu",))
    return out, export_aot.save_artifact(out, params, cfg, VOCAB, **kw)


def live(params, cfg):
    return Captioner(params, cfg, VOCAB, device="cpu")


@pytest.mark.parametrize("beam", [1, 3])
def test_artifact_roundtrip_matches_live(tmp_path, beam):
    """Save -> load -> caption == live Captioner, greedy and beam,
    through a padded chunk (n = decode_batch + 1)."""
    cfg = config(beam=beam, batch=3)
    p = weights()
    out, manifest = save(tmp_path, p, cfg)
    assert manifest["format"] == "stvd-torch-aot-decode-v1"
    assert manifest["decode_batch"] == 3 and manifest["beam_size"] == beam
    assert manifest["use_kernel"] is False and manifest["custom_ops"] == []
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert sorted(os.listdir(out)) == ["config.json", "decode_b3_cpu.pt2",
                                       "manifest.json", "params.npz",
                                       "vocab.pkl"]
    served = export_aot.load_artifact(out, device="cpu")
    feats, _, _ = feats_for(4)
    assert served.caption(feats) == live(p, cfg).caption(feats)


@pytest.mark.parametrize("beam", [1, 3])
def test_artifact_matches_the_jax_artifact(tmp_path, beam):
    """The port's CPU artifact and the JAX package's CPU artifact of the
    same weights caption the same features identically; the params,
    vocabulary and config files load in either package."""
    cfg = config(beam=beam, batch=3)
    p = weights(seed=3)
    out, _ = save(tmp_path, p, cfg, "torch")
    jout = str(tmp_path / "jax")
    jexport.save_artifact(jout, {k: jax.numpy.asarray(v)
                                 for k, v in p.items()},
                          cfg, VOCAB, platforms=("cpu",))
    feats, _, _ = feats_for(5, seed=4)
    got = export_aot.load_artifact(out, device="cpu").caption(feats)
    assert got == jexport.load_artifact(jout).caption(feats)
    # either package's weights, vocabulary and config feed the other
    with np.load(os.path.join(out, "params.npz")) as z:
        jparams = {k: jax.numpy.asarray(z[k]) for k in z.files}
    jv = Vocab.load_pickle(os.path.join(out, "vocab.pkl"))
    with open(os.path.join(out, "config.json")) as f:
        jcfg = Config.from_json(f.read())
    assert JCaptioner(jparams, jcfg, jv).caption(feats) == got


def test_artifact_spatial_motion_roundtrip(tmp_path):
    """Preset-2/4-shaped artifact: regions and motion ride the graph's
    inputs."""
    m = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                            region_dim=16, use_motion=True, motion_dim=12)
    cfg = config(m)
    p = weights(m, seed=1)
    out, manifest = save(tmp_path, p, cfg)
    assert sorted(manifest["inputs"]["2"]) == ["frame_mask", "frames",
                                               "motion", "regions"]
    feats, regs, mots = feats_for(3, m, seed=1, spatial=True, motion=True)
    assert (export_aot.load_artifact(out, device="cpu")
            .caption(feats, regs, mots)
            == live(p, cfg).caption(feats, regs, mots))


@pytest.mark.parametrize("what", ["int8", "bf16"])
def test_artifact_int8_and_bf16(tmp_path, what):
    """W8A8 gates and bf16 compute are traced into the graph (weights
    stay float32 call-time inputs, cast and quantized inside it); the
    artifact equals the live Captioner."""
    m = dataclasses.replace(MCFG, **({"decode_quant": "int8"}
                                     if what == "int8"
                                     else {"compute_dtype": "bfloat16"}))
    cfg = config(m)
    p = weights(m, seed=2)
    out, manifest = save(tmp_path, p, cfg)
    with np.load(os.path.join(out, "params.npz")) as z:
        assert all(z[k].dtype == np.float32 for k in z.files)
    feats, _, _ = feats_for(3, m, seed=5)
    assert (export_aot.load_artifact(out, device="cpu").caption(feats)
            == live(p, cfg).caption(feats))


def test_artifact_weight_swap_no_reexport(tmp_path):
    """Weights are call-time inputs: ``params=`` at load and
    ``swap_params`` change the output without re-export; another
    architecture is refused."""
    cfg = config()
    p0, p1 = weights(seed=0), weights(seed=7)
    p1["ff_logit_b"] = p1["ff_logit_b"] + np.linspace(
        0, 2, p1["ff_logit_b"].size, dtype=np.float32)
    out, _ = save(tmp_path, p0, cfg)
    feats, _, _ = feats_for(2, seed=3)
    want1 = live(p1, cfg).caption(feats)
    assert want1 != live(p0, cfg).caption(feats)
    assert export_aot.load_artifact(out, params=p1,
                                    device="cpu").caption(feats) == want1
    served = export_aot.load_artifact(out, device="cpu")
    served.swap_params(p1)
    assert served.caption(feats) == want1
    bad = dict(p1, W=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        served.swap_params(bad)
    with pytest.raises(ValueError, match="key mismatch"):
        served.swap_params({k: v for k, v in p1.items() if k != "W"})


@pytest.fixture(scope="module")
def bucketed(tmp_path_factory):
    cfg = config(beam=2, batch=4)
    p = weights()
    out, manifest = save(tmp_path_factory.mktemp("bucketed"), p, cfg,
                         batch_sizes=(4, 2))
    return export_aot.load_artifact(out, device="cpu"), live(p, cfg), \
        manifest


@pytest.mark.parametrize("n,want", [
    (1, [(2, 0, 1)]), (3, [(4, 0, 3)]), (4, [(4, 0, 4)]),
    (7, [(4, 0, 4), (4, 4, 7)])])
def test_bucketed_artifact_routes_and_matches_live(bucketed, n, want):
    """batch_sizes=(2, 4): bulk chunks ride b=4, the remainder the
    smallest graph that fits; captions equal the live Captioner's for
    every request size."""
    served, cap, manifest = bucketed
    assert manifest["batch_sizes"] == [2, 4]
    assert list(served._buckets(n)) == want
    feats, _, _ = feats_for(n, seed=n)
    assert served.caption(feats) == cap.caption(feats)


def test_nbest_artifact_matches_live(tmp_path):
    """nbest=True: caption_nbest equals the live Captioner's (texts and
    scores, both rankings) through a chunked request; ``n`` caps the
    lists and entry 0 is ``caption``'s caption."""
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=3, maxlen=8,
                                                 decode_batch=2,
                                                 length_norm=0.6))
    p = weights(seed=5)
    out, manifest = save(tmp_path, p, cfg, nbest=True)
    assert manifest["nbest"] is True
    assert os.path.exists(os.path.join(out, "nbest_b2_cpu.pt2"))
    served = export_aot.load_artifact(out, device="cpu")
    cap = live(p, cfg)
    feats, _, _ = feats_for(5, seed=7)
    batch = pack_request(MCFG, feats, device="cpu")
    for norm in (True, False):
        got = served.caption_nbest(batch, norm=norm)
        want = cap.caption_nbest(batch, norm=norm)
        assert [[t for t, _ in v] for v in got] \
            == [[t for t, _ in v] for v in want]
        assert [[s for _, s in v] for v in got] \
            == [[s for _, s in v] for v in want]
    top1 = served.nbest(feats, n=1)
    assert all(len(v) == 1 for v in top1)
    assert [v[0][0] for v in top1] == [v[0][0] for v in cap.nbest(feats, n=1)]
    assert [v[0][0] for v in top1] == served.caption(feats)


def test_nbest_absent_raises(tmp_path):
    out, _ = save(tmp_path, weights(seed=6), config())
    feats, _, _ = feats_for(2)
    with pytest.raises(ValueError, match="no n-best graphs"):
        export_aot.load_artifact(out, device="cpu").nbest(feats)


def test_nbest_export_requires_beam(tmp_path):
    with pytest.raises(ValueError, match="beam_size > 1"):
        save(tmp_path, weights(seed=7), config(beam=1), nbest=True)


def test_example_batch_matches_serving_shapes():
    m = dataclasses.replace(MCFG, use_spatial=True, n_regions=4,
                            region_dim=16)
    b = export_aot.example_batch(config(m, batch=3), device="cpu")
    assert b["frames"].shape == (3, 6, 32)
    assert b["regions"].shape == (3, 6, 4, 16)
    assert b["frame_mask"].shape == (3, 6)
    assert str(b["frames"].dtype) == "torch." + m.compute_dtype
    assert b["frame_mask"].dtype == torch.float32
    assert bool((b["frame_mask"][:, 0] == 1).all())
    served = pack_request(m, np.zeros((3, 6, 32), np.float32),
                          [np.zeros((6, 4, 16), np.float32)] * 3,
                          device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in b.items()} \
        == {k: (v.shape, v.dtype) for k, v in served.items()}


def test_kernel_multi_platform_rejected():
    with pytest.raises(ValueError, match="only run on cuda"):
        export_aot.export_decoder(weights(), config(),
                                  platforms=("cuda", "cpu"),
                                  use_kernel=True)
    with pytest.raises(ValueError, match="subset"):
        export_aot.export_decoder(weights(), config(), platforms=("tpu",))


@pytest.mark.parametrize("saved,device,error,match", [
    (("cpu",), "cuda", ValueError, "re-export"),
    (("cuda",), "cpu", ValueError, "re-export"),
    (("cuda",), "cuda", RuntimeError, "no CUDA device"),
])
def test_load_artifact_platform_mismatch(tmp_path, monkeypatch, saved,
                                         device, error, match):
    """A graph is bound to its platform: loading it for another device
    type fails fast, and a CUDA artifact without a card raises rather
    than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, _ = save(tmp_path, weights(), config(), platforms=saved)
    with pytest.raises(error, match=match):
        export_aot.load_artifact(out, device=device)


def test_load_rejects_a_jax_artifact(tmp_path):
    cfg = config()
    out = str(tmp_path / "jax")
    jexport.save_artifact(out, init_params(jax.random.PRNGKey(0), MCFG),
                          cfg, VOCAB, platforms=("cpu",))
    with pytest.raises(ValueError, match="stvd-aot-decode-v1.*"
                                         "stvd-torch-aot-decode-v1"):
        export_aot.load_artifact(out, device="cpu")


@pytest.mark.parametrize("kw", [{"data_parallel": 2},
                                {"model_parallel": 2}])
def test_sharded_artifacts_raise(tmp_path, kw):
    """Sharded artifacts are exported on their ranks
    (tests/test_torch_sharded_serving.py).  In a lone process the JAX
    package's refusals stand: a batch size the data degree does not
    divide (the same words), and a world without the ranks."""
    jout = str(tmp_path / "jax")
    with pytest.raises(ValueError) as jerr:
        jexport.save_artifact(jout, init_params(jax.random.PRNGKey(0), MCFG),
                              config(), VOCAB, platforms=("cpu",),
                              batch_sizes=(3,), data_parallel=2)
    with pytest.raises(ValueError) as err:
        save(tmp_path, weights(), config(), batch_sizes=(3,),
             data_parallel=2, device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match=r"needs 2 devices; (only )?1 "
                                         r"visible"):
        save(tmp_path, weights(), config(), batch_sizes=(2,), device="cpu",
             **kw)


def test_sharded_graph_and_manifest_raise(tmp_path):
    """A graph for a mesh needs one with a data axis; a sharded
    artifact's manifest rebuilds its mesh, which a lone process cannot
    hold (the JAX loader's refusal of too few devices)."""
    with pytest.raises(ValueError, match="'data'"):
        export_aot.export_decoder(weights(), config(), platforms=("cpu",),
                                  mesh=object())
    out, _ = save(tmp_path, weights(), config())
    path = os.path.join(out, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["data_parallel"] = 2
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="data_parallel=2 needs 2 devices; "
                                         "only 1 visible"):
        export_aot.load_artifact(out, device="cpu")


def counting(step_fn, steps):
    def counted(*args):
        steps[0] += 1
        return step_fn(*args)
    return counted


def eos_after_one_word(seed=1, bias=2.5):
    """Weights that suppress EOS at the first step and favour it after
    any word: the zero embedding of step 0 leaves activation 0 near -1
    (bias -3), every word's embedding lifts it to near 0, and only EOS
    reads it (weight 10)."""
    p = numpy_params(MCFG, seed=seed)
    p["Wemb"][:, 0] = 3.0
    p["ff_logit_lstm_b"][0] = -3.0
    p["ff_logit_W"][0, :] = 0.0
    p["ff_logit_W"][0, 0] = 10.0
    p["ff_logit_b"][0] = bias
    return p


@pytest.mark.parametrize("beam", [1, 3])
def test_full_maxlen_graph_equals_early_exit(tmp_path, beam):
    """Weights that favour EOS end every caption before maxlen, so the
    live loop exits early; the graph runs all maxlen steps and gives the
    same tokens and scores, exactly."""
    cfg = config(beam=beam, batch=4, maxlen=10)
    p = eos_after_one_word()
    out, _ = save(tmp_path, p, cfg)
    served = export_aot.load_artifact(out, device="cpu")
    cap = live(p, cfg)
    steps = [0]
    cap.step_fn = counting(cap.step_fn, steps)
    feats, _, _ = feats_for(4, seed=9)
    batch = pack_request(MCFG, feats, device="cpu")
    toks, scores = cap._run(cap.params, batch)
    assert 1 < steps[0] < cfg.decode.maxlen
    assert bool(((toks != 0).sum(1) >= 1).all())
    assert bool((toks[:, -1] == 0).all())
    g_toks, g_scores = served._call_fn(served._exported[4])(served.params,
                                                           batch)
    assert torch.equal(g_toks, toks)
    assert torch.equal(g_scores, scores)


def test_a_loaded_artifact_runs_no_model_code(tmp_path, monkeypatch):
    """The graph is pinned: with the port's beam search and step made to
    raise, a loaded artifact still captions, and as before."""
    cfg = config(beam=3, batch=2)
    out, _ = save(tmp_path, weights(seed=9), cfg)
    feats, _, _ = feats_for(3, seed=10)
    before = export_aot.load_artifact(out, device="cpu").caption(feats)
    from stvd_torch.decode import beam
    from stvd_torch.model import step

    def boom(*a, **k):
        raise AssertionError("model code ran")

    monkeypatch.setattr(beam, "beam_decode", boom)
    monkeypatch.setattr(step, "step", boom)
    assert export_aot.load_artifact(out, device="cpu").caption(feats) \
        == before


def launches():
    return {k: getattr(kernel, k).launches for k in KERNELS}


@pytest.mark.parametrize("model,ops", [
    ({"compute_dtype": "bfloat16"}, ["attention_core", "logit_tail"]),
    ({"compute_dtype": "bfloat16", "decode_quant": "int8",
      "gates_kernel": "on", "dim": 32},
     ["attention_core", "gates_lstm", "logit_tail"]),
    ({"compute_dtype": "bfloat16", "use_spatial": True, "n_regions": 4,
      "region_dim": 16}, ["attention_core", "logit_tail", "spatial_core"]),
])
def test_cuda_platform_export_on_a_cpu_host(tmp_path, model, ops):
    """A CUDA-platform artifact is traced on fake tensors on a host
    without a card (preset-3-, int8-gates- and preset-2-shaped tiny
    configs): the kernel step is taken by default, the saved and reloaded
    graph holds the kernels' custom ops, and no kernel runs."""
    m = dataclasses.replace(MCFG, **model)
    before = launches()
    out, manifest = save(tmp_path, weights(m), config(m, beam=3),
                         platforms=("cuda",), nbest=True)
    want = ["stvd_torch::" + op for op in ops]
    assert manifest["use_kernel"] is True
    assert manifest["custom_ops"] == want
    for name in ("decode", "nbest"):
        ep = torch.export.load(os.path.join(out, f"{name}_b2_cuda.pt2"))
        assert export_aot.custom_ops(ep) == want
        counts = {}
        for n in ep.graph.nodes:
            if (n.op == "call_function"
                    and isinstance(n.target, torch._ops.OpOverload)
                    and n.target.namespace == "stvd_torch"):
                counts[n.target.name()] = counts.get(n.target.name(), 0) + 1
        # one launch of each kernel a decode step
        assert set(counts.values()) == {8}
        devices = {str(n.meta["val"].device) for n in ep.graph.nodes
                   if n.op == "placeholder"}
        assert devices == {"cuda:0"}
    assert launches() == before


def test_export_fails_at_shapes_the_kernel_refuses(tmp_path):
    """The custom ops' fakes apply the kernels' checks: nine beams are
    more than the attention core takes, so the CUDA export fails when
    traced, not when served."""
    m = dataclasses.replace(MCFG, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="beams"):
        save(tmp_path, weights(m), config(m, beam=9), platforms=("cuda",))


def fake_operands(op):
    """CUDA fake operands of each kernel's op at a tiny shape, and one
    argument the kernel refuses."""
    cuda = torch.device("cuda")

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=cuda)

    if op == "attention_core":
        good = (t(6, 8), t(6), t(2, 5, 8), t(2, 5, 16), t(2, 5), t(8),
                t(1), t(1), True)
        return good, {1: t(5)}, [(6, 16), (6, 5)]
    if op == "logit_tail":
        good = (t(6, 8), t(8, 40, dtype=torch.bfloat16), t(40), 3)
        return good, {2: t(39)}, [(6, 3), (6, 3), (6,)]
    if op == "spatial_core":
        good = (t(6, 8), t(2, 5, 4, 8), t(2, 5, 4, 16), t(8), t(1))
        return good, {2: t(2, 5, 3, 16)}, [(2, 3, 5, 16), (2, 3, 5, 4)]
    good = (t(6, 24, dtype=torch.bfloat16), t(24, 32, dtype=torch.bfloat16),
            t(32), t(6, 8), None, None)
    return good, {0: t(6, 24)}, [(6, 8), (6, 8)]


@pytest.mark.parametrize("op", KERNELS)
def test_custom_op_fakes_check_what_the_kernel_takes(op):
    """Each op's fake gives the kernel's output shapes and raises the
    kernel's ValueError on an operand it refuses."""
    fn = getattr(torch.ops.stvd_torch, op)
    with FakeTensorMode():
        good, bad, shapes = fake_operands(op)
        assert [tuple(o.shape) for o in fn(*good)] == shapes
        args = list(good)
        for i, v in bad.items():
            args[i] = v
        with pytest.raises(ValueError, match=op):
            fn(*args)


@pytest.mark.parametrize("op", KERNELS)
def test_custom_ops_have_no_cpu_implementation(op):
    """The ops run only on the card: on CPU tensors they raise (the CPU
    takes the plain step, never a plain substitute inside the op)."""
    with FakeTensorMode():
        good, _, _ = fake_operands(op)
    cpu = [torch.zeros(a.shape, dtype=a.dtype)
           if isinstance(a, torch.Tensor) else a for a in good]
    with pytest.raises(NotImplementedError):
        getattr(torch.ops.stvd_torch, op)(*cpu)
