"""The port's command-line entry points against the JAX package's.

Two run directories are made from one weight set: numpy weights written
with the JAX ``save_reference_npz``, then each package's ``cli.convert
--ref-model`` with the same ``--worddict``.  Both run directories then
get the same tiny float32 config (synthetic corpus of 8 training
videos, beam 3, decode batch 3), and each package's ``cli.sample`` runs
on its own directory on the CPU.  Sample and score files must be equal,
float32 numbers within 1e-5.
"""

import argparse
import dataclasses
import filecmp
import json
import os
import pickle

import numpy as np
import pytest
import torch

from stvd.cli import convert as jconvert
from stvd.cli import sample as jsample
from stvd.cli import score as jscore
from stvd.cli import train as jtrain
from stvd.model.importer import save_reference_npz
from stvd_torch.cli import convert as tconvert
from stvd_torch.cli import sample as tsample
from stvd_torch.cli import score as tscore
from stvd_torch.cli import train as ttrain
from stvd_torch.config import Config, DecodeConfig
from stvd_torch.train import loop as tloop

from conftest import small_cfg
from test_torch_step import numpy_params

MCFG = small_cfg()
TOL = dict(rtol=0, atol=1e-5)
WORDS = {f"w{i}": i for i in range(2, MCFG.n_words)}


def make_run_dirs(root, seed=5, beam=3, params=None):
    """(JAX run dir, port run dir) of one weight set, made by each
    package's ``cli.convert --ref-model`` and given one tiny config."""
    root = str(root)
    npz = os.path.join(root, "model.npz")
    save_reference_npz(npz, params if params is not None
                       else numpy_params(MCFG, seed=seed))
    wd = os.path.join(root, "worddict.pkl")
    with open(wd, "wb") as f:
        pickle.dump(WORDS, f, protocol=2)
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "torch")
    assert jconvert.main(["--ref-model", npz, "--worddict", wd,
                          "--run-dir", jdir]) == 0
    assert tconvert.main(["--ref-model", npz, "--worddict", wd,
                          "--run-dir", tdir, "--device", "cpu"]) == 0
    with open(os.path.join(jdir, "config.json")) as f:
        jtext = f.read()
    with open(os.path.join(tdir, "config.json")) as f:
        assert f.read() == jtext
    cfg = Config.from_json(jtext)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, n_frames=MCFG.n_frames,
                                  compute_dtype="float32"),
        decode=DecodeConfig(beam_size=beam, maxlen=8, decode_batch=3),
        data=dataclasses.replace(cfg.data, synthetic_videos=8))
    for d in (jdir, tdir):
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(cfg.to_json())
    return jdir, tdir


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return make_run_dirs(tmp_path_factory.mktemp("rundirs"))


@pytest.fixture(scope="module")
def sampled(run_dirs):
    """Both sample CLIs with every file-writing flag, on valid."""
    jdir, tdir = run_dirs
    flags = ["--split", "valid", "--nbest", "2", "--dump-attention", "3",
             "--nll", "--stochastic", "2", "--top-k", "3"]
    assert jsample.main(["--run-dir", jdir] + flags) == 0
    assert tsample.main(["--run-dir", tdir, "--device", "cpu"] + flags) == 0
    return jdir, tdir


def read_json(path):
    with open(path) as f:
        return json.load(f)


def assert_tree_close(got, want, path="$"):
    """Equal JSON trees, numbers within ``TOL``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, err_msg=path, **TOL)
    else:
        assert got == want, path


def test_convert_writes_a_port_run_dir(run_dirs):
    _, tdir = run_dirs
    for name in ("config.json", "ckpt.pt", "ckpt_best.pt", "vocab.pkl"):
        assert os.path.isfile(os.path.join(tdir, name)), name
    blob = torch.load(os.path.join(tdir, "ckpt.pt"), weights_only=True)
    want = numpy_params(MCFG, seed=5)
    assert sorted(blob["params"]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(blob["params"][k].numpy(), v, k)
    assert blob["step"] == 0


@pytest.mark.parametrize("name", ["valid_samples.txt",
                                  "valid_samples.json"])
def test_sample_files_are_byte_identical(sampled, name):
    jdir, tdir = sampled
    assert filecmp.cmp(os.path.join(jdir, name), os.path.join(tdir, name),
                       shallow=False)


def test_scores_files_are_equal(sampled):
    jdir, tdir = sampled
    got = read_json(os.path.join(tdir, "valid_scores.json"))
    want = read_json(os.path.join(jdir, "valid_scores.json"))
    assert_tree_close(got, want)
    assert got["checkpoint"] == "ckpt" and got["corpus"]["synthetic"]
    for k in ("nll", "nll_per_token", "perplexity", "METEOR"):
        assert k in got["scores"], k


def test_nbest_files_are_equal(sampled):
    jdir, tdir = sampled
    got = read_json(os.path.join(tdir, "valid_nbest.json"))
    want = read_json(os.path.join(jdir, "valid_nbest.json"))
    assert_tree_close(got, want)
    assert len(got) == 2 and len(got[0]["beams"]) == 3


def test_attention_dumps_agree(sampled):
    jdir, tdir = sampled
    with np.load(os.path.join(jdir, "valid_attention.npz")) as j, \
            np.load(os.path.join(tdir, "valid_attention.npz")) as t:
        assert sorted(t.files) == sorted(j.files)
        for k in ("ids", "tokens", "frame_mask"):
            np.testing.assert_array_equal(t[k], j[k], k)
        assert t["alphas"].shape == (3, 8, MCFG.n_frames)
        np.testing.assert_allclose(t["alphas"], j["alphas"], **TOL)


def test_sampled_file_has_the_jax_layout(sampled):
    """The draws differ (another generator), the layout must not."""
    jdir, tdir = sampled
    got = read_json(os.path.join(tdir, "valid_sampled.json"))
    want = read_json(os.path.join(jdir, "valid_sampled.json"))
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert all(len(r["samples"]) == 2 and all(
        set(s) == {"caption", "logprob"} and s["logprob"] <= 0
        for s in r["samples"]) for r in got)


def test_sample_quant_leaves_the_files_alone(sampled, capsys):
    """--quant int8 prints its scores but writes neither samples nor
    scores, and suffixes its n-best file."""
    _, tdir = sampled
    path = os.path.join(tdir, "valid_scores.json")
    before = open(path).read()
    assert tsample.main(["--run-dir", tdir, "--device", "cpu", "--split",
                         "valid", "--nbest", "2", "--quant", "int8"]) == 0
    out = capsys.readouterr().out
    assert "METEOR" in json.loads(out[out.index("{\n"):])
    assert open(path).read() == before
    assert os.path.isfile(os.path.join(tdir, "valid_nbest.int8.json"))


def test_sample_run_maps_a_missing_run_dir_to_exit_2(tmp_path, monkeypatch):
    monkeypatch.setattr("sys.argv", ["sample", "--run-dir",
                                     str(tmp_path / "none")])
    assert tsample.run() == 2


# ---- score -----------------------------------------------------------------

REFS = {"vid1": ["a man is playing a guitar", "a person plays the guitar"],
        "vid2": ["a cat sits on a mat", "the cat is sitting down"],
        "vid3": ["children are running in a park"]}
HYPS = {"vid1": "a man is playing a guitar", "vid2": "a cat sits on the mat",
        "vid3": "children run in a park"}


@pytest.mark.parametrize("fmt", ["json_rows", "txt", "dict"])
def test_score_cli_writes_the_jax_file(tmp_path, fmt, capsys, monkeypatch):
    """The same file as the JAX CLI's with its pure-Python scorers; its
    native CIDEr (which the port does not use: its n-gram hash is not
    injective) may differ in the last bit."""
    refs = tmp_path / "refs.json"
    refs.write_text(json.dumps(REFS))
    (tmp_path / "PROVENANCE.json").write_text(json.dumps({"synthetic": True}))
    if fmt == "json_rows":
        hyp = tmp_path / "test_samples.json"
        hyp.write_text(json.dumps([{"image_id": v, "caption": c}
                                   for v, c in HYPS.items()]))
    elif fmt == "txt":
        hyp = tmp_path / "test_samples.txt"
        hyp.write_text("".join(f"{v}\t{c}\n" for v, c in HYPS.items()))
    else:
        hyp = tmp_path / "hyp.json"
        hyp.write_text(json.dumps(HYPS))
    assert (tscore.load_hypotheses(str(hyp))
            == jscore.load_hypotheses(str(hyp)))
    from stvd.metrics import _native as jnative
    outs = {}
    for name, mod in (("jax", jscore), ("torch", tscore), ("python", None)):
        outs[name] = str(tmp_path / f"{name}.json")
        if mod is None:
            mod = jscore
            monkeypatch.setattr(jnative, "get_lib", lambda: None)
        assert mod.main(["--hyp", str(hyp), "--refs", str(refs),
                         "--out", outs[name]]) == 0
    got = read_json(outs["torch"])
    want = read_json(outs["python"])
    assert got == want
    native = read_json(outs["jax"])
    assert got["scores"] == pytest.approx(native["scores"], rel=1e-12)
    assert got["scores"]["Bleu_4"] > 0 and "caveat" in got
    capsys.readouterr()


@pytest.mark.parametrize("body,what", [
    ("", "empty"), ("{\"vid1\": 3}", "no caption"),
    ("[{\"image_id\": \"vid1\"}]", "rows")])
def test_score_cli_rejects_what_jax_rejects(tmp_path, body, what):
    hyp = tmp_path / "hyp.json"
    hyp.write_text(body)
    errors = []
    for mod in (jscore, tscore):
        try:
            mod.load_hypotheses(str(hyp))
        except ValueError as e:
            errors.append(str(e))
        except json.JSONDecodeError as e:
            errors.append(type(e).__name__)
    assert len(errors) == 2 and errors[0] == errors[1], (what, errors)


def test_score_cli_ids_and_missing_hypotheses(tmp_path, capsys):
    refs = tmp_path / "refs.json"
    refs.write_text(json.dumps(REFS))
    hyp = tmp_path / "hyp.json"
    hyp.write_text(json.dumps({"vid1": HYPS["vid1"]}))
    ids = tmp_path / "ids.txt"
    ids.write_text("vid1\n")
    assert tscore.main(["--hyp", str(hyp), "--refs", str(refs),
                        "--ids", str(ids)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jscore.main(["--hyp", str(hyp), "--refs", str(refs),
                        "--ids", str(ids)]) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert tscore.main(["--hyp", str(hyp), "--refs", str(refs),
                        "--intersect"]) == 0
    capsys.readouterr()


# ---- convert ---------------------------------------------------------------

def test_convert_features_banks_load_equal(tmp_path):
    from stvd.data.bank import FeatureBank as JBank
    from stvd_torch.data.bank import FeatureBank as TBank
    rng = np.random.RandomState(3)
    feats = {f"vid{i}": rng.randn(int(f), 8).astype(np.float32)
             for i, f in enumerate(rng.randint(2, 12, size=5))}
    regs = {v: rng.randn(a.shape[0], 3, 4).astype(np.float32)
            for v, a in feats.items()}
    for name, obj in (("f.pkl", feats), ("r.pkl", regs)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    banks = {}
    for name, mod in (("jax", jconvert), ("torch", tconvert)):
        out = str(tmp_path / f"{name}.npz")
        assert mod.main(["--features", str(tmp_path / "f.pkl"), "--regions",
                         str(tmp_path / "r.pkl"), "--frames", "6",
                         "--out", out]) == 0
        banks[name] = out
    for load in (JBank.load, TBank.load):
        a, b = load(banks["jax"]), load(banks["torch"])
        assert a.ids == b.ids and b.n_videos == 5
        for k in ("frames", "frame_mask", "regions"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
        assert a.motion is None and b.motion is None


def test_convert_build_vocab_pickles_are_equal(tmp_path):
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps(REFS))
    outs = []
    for name, mod in (("jax", jconvert), ("torch", tconvert)):
        outs.append(str(tmp_path / f"{name}.pkl"))
        assert mod.main(["--build-vocab", str(caps), "--out", outs[-1],
                         "--max-words", "12"]) == 0
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    assert filecmp.cmp(outs[0], outs[1], shallow=False)


# ---- train -----------------------------------------------------------------

TRAIN_FLAGS = [
    "--preset", "msvd-beam",
    "--set", "model.dim=24", "--set", "model.ctx_dim=16",
    "--set", "model.n_frames=4", "--set", "model.n_words=32",
    "--set", "model.dim_word=16", "--set", "model.compute_dtype=float32",
    "--set", "data.synthetic_videos=6", "--set", "decode.decode_batch=4",
    "--set", "decode.maxlen=8", "--set", "train.batch_size=6",
    "--set", "train.valid_freq=2", "--set", "train.disp_freq=2",
    "--set", "train.sample_freq=2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("train"))
    flags = TRAIN_FLAGS + ["--set", f"train.save_dir={d}"]
    assert ttrain.main(flags + ["--device", "cpu", "--max-updates", "4"]) == 0
    return d, flags


def test_train_cli_writes_the_run_dir(trained):
    d, _ = trained
    for name in ("config.json", "vocab.pkl", "ckpt.pt", "ckpt_best.pt",
                 "metrics.jsonl", "valid_samples.txt", "test_samples.json"):
        assert os.path.isfile(os.path.join(d, name)), name
    with open(os.path.join(d, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    kinds = [r["kind"] for r in recs]
    assert kinds[-1] == "done" and "valid" in kinds and "test" in kinds
    assert all("elapsed_s" in r for r in recs)      # through the logger
    assert recs[-1]["best_step"] in (2, 4)


def test_train_cli_config_and_vocab_load_in_both_packages(trained):
    from stvd.config import Config as JConfig
    from stvd.data.text import Vocab as JVocab
    d, flags = trained
    with open(os.path.join(d, "config.json")) as f:
        text = f.read()
    ns = argparse.Namespace(config=None, preset="msvd-beam",
                            set=[s for s in flags if "=" in s])
    assert text == jtrain.build_config(ns).to_json()
    assert JConfig.from_json(text).to_json() == text
    assert Config.from_json(text).to_json() == text
    v = JVocab.load_pickle(os.path.join(d, "vocab.pkl"))
    assert len(v) > 2 and v.decode([2, 0]) == [v.id_to_word[2]]


def test_train_cli_run_then_sample(trained, capsys):
    """The README's workflow in the port: train, then sample the run."""
    d, _ = trained
    assert tsample.main(["--run-dir", d, "--device", "cpu", "--best",
                         "--split", "test", "--beam", "2"]) == 0
    out = capsys.readouterr().out
    assert "METEOR" in json.loads(out[out.index("{\n"):])
    assert read_json(os.path.join(d, "test_scores.json"))["checkpoint"] \
        == "ckpt_best"


@pytest.mark.parametrize("sets", [
    ["train.max_epochs=3", "model.use_dropout=false", "train.lr=0.5",
     "train.optimizer=adam"],
    ["decode.beam_size=1", "data.dataset=synthetic-hard",
     "model.compute_dtype=float32", "train.length_buckets=10,20"],
    ["model.gates_kernel=on", "model.decode_quant=int8",
     "train.data_parallel=yes", "train.metric=cider"]])
def test_apply_overrides_and_build_config_match_jax(sets):
    ns = argparse.Namespace(config=None, preset="msvd-spatial", set=sets)
    assert (ttrain.build_config(ns).to_json()
            == jtrain.build_config(ns).to_json())
    from stvd.config import Config as JConfig
    assert (ttrain.apply_overrides(Config(), sets).to_json()
            == jtrain.apply_overrides(JConfig(), sets).to_json())


def test_build_config_of_a_recipe_matches_jax():
    recipe = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "recipes", "msvd_fast.json")
    ns = argparse.Namespace(config=recipe, preset=None,
                            set=["train.save_dir=x", "model.dim=64"])
    assert (ttrain.build_config(ns).to_json()
            == jtrain.build_config(ns).to_json())


@pytest.mark.parametrize("sets,what", [
    (["train.model_parallel=2"], "model parallelism"),
    ([], None)])
def test_train_cli_parallel_flags(tmp_path, sets, what, monkeypatch):
    """Data parallelism in one process is a single-device run; under a
    launcher (``WORLD_SIZE`` above 1) it trains over the data mesh, with
    the spelling of ``--shard-map``; tensor parallelism in one process
    raises, as one device does not divide the model axis.  Runs over real
    ranks: tests/test_torch_parallel.py and
    tests/test_torch_tensor_parallel.py."""
    d = str(tmp_path / "r")
    flags = TRAIN_FLAGS + ["--set", f"train.save_dir={d}",
                           "--set", "train.valid_freq=0",
                           "--set", "train.sample_freq=0",
                           "--data-parallel", "--device", "cpu",
                           "--max-updates", "1"]
    for s in sets:
        flags += ["--set", s]
    if what:
        with pytest.raises(ValueError, match="model_parallel=2"):
            ttrain.main(flags)
        return
    assert ttrain.main(flags) == 0

    class Mesh:
        mesh_dim_names = ("data",)

        def get_local_rank(self, name):
            return 0

    seen = {}

    def fit(cfg, train_ds, valid_ds=None, step_fn=None, mesh=None, **kw):
        seen.update(mesh=mesh, **kw)
        return tloop.FitResult(0.0, 0, [], {})

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(ttrain.parallel, "make_mesh",
                        lambda devices=None, backend=None: Mesh())
    monkeypatch.setattr(ttrain, "fit", fit)
    assert ttrain.main(flags + ["--shard-map"]) == 0
    assert isinstance(seen["mesh"], Mesh)
    assert seen["use_shard_map"] is True


def test_train_run_maps_bad_config_to_exit_2(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["train", "--preset", "msvd-beam",
                                     "--set", "train.optimizer=lamb"])
    assert ttrain.run() == 2
    assert "optimizer" in capsys.readouterr().err


# ---- logging ---------------------------------------------------------------

def test_metrics_logger_matches_jax(tmp_path, capsys):
    from stvd.utils.logging import MetricsLogger as JLogger
    from stvd_torch.utils.logging import MetricsLogger as TLogger
    lines = {}
    for name, cls in (("jax", JLogger), ("torch", TLogger)):
        log = cls(str(tmp_path / name))
        log.log("train", update=3, loss=np.float32(1.5), note="x")
        log.close()
        with open(tmp_path / name / "metrics.jsonl") as f:
            rec = json.loads(f.read())
        rec.pop("elapsed_s")
        lines[name] = rec
    assert lines["torch"] == lines["jax"] == {
        "kind": "train", "update": 3, "loss": 1.5, "note": "x"}
    out = capsys.readouterr().out.splitlines()
    assert out[0].split()[0] == out[1].split()[0] == "[train]"


def test_clis_default_to_the_card(run_dirs, tmp_path, monkeypatch):
    """Without --device the CLIs are for the card: where there is none
    they raise instead of running on the CPU."""
    from stvd_torch.cli import serve as tserve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tdir = run_dirs
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(TRAIN_FLAGS + ["--set", f"train.save_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tsample.main(["--run-dir", tdir])
    with pytest.raises(RuntimeError, match="--device cpu"):
        tconvert.main(["--ref-model", str(tmp_path / "m.npz"),
                       "--run-dir", str(tmp_path / "r")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.build_server(argparse.Namespace(
            artifact=None, run_dir=tdir, quant=None, host="127.0.0.1",
            port=0, verbose=False))


def test_export_cli_check_exits_0(run_dirs, tmp_path, capsys):
    """cli.export on the port's run dir: a CPU artifact of sizes 1 and 3
    with n-best graphs, held to the live Captioner by --check (4 random
    videos, a padded chunk); it serves the JAX Captioner's captions."""
    from stvd.api import Captioner as JCaptioner
    from stvd_torch.cli import export as texport
    from stvd_torch.export_aot import load_artifact
    jdir, tdir = run_dirs
    out = str(tmp_path / "artifact")
    assert texport.main(["--run-dir", tdir, "--out", out, "--platforms",
                         "cpu", "--batch", "1,3", "--nbest", "--check",
                         "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "check: OK" in text and "(4/4 equal" in text
    assert sorted(os.listdir(out)) == [
        "config.json", "decode_b1_cpu.pt2", "decode_b3_cpu.pt2",
        "manifest.json", "nbest_b1_cpu.pt2", "nbest_b3_cpu.pt2",
        "params.npz", "vocab.pkl"]
    feats = np.random.RandomState(2).randn(
        4, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    assert (load_artifact(out, device="cpu").caption(feats)
            == JCaptioner.from_run_dir(jdir).caption(feats))


def test_export_cli_cuda_platform_and_unported_flags(run_dirs, tmp_path,
                                                     capsys, monkeypatch):
    """--platforms cuda exports the kernel step's graph on a host without
    a card (the check is skipped on a CPU --device); sharded exports
    need their ranks (a lone process refuses them as the JAX package
    refuses too few devices); without --device the CLI wants the
    card."""
    from stvd_torch.cli import export as texport
    _, tdir = run_dirs
    out = str(tmp_path / "cuda")
    assert texport.main(["--run-dir", tdir, "--out", out, "--platforms",
                         "cuda", "--check", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "kernel=True" in text and "check skipped" in text
    assert read_json(os.path.join(out, "manifest.json"))["custom_ops"] == [
        "stvd_torch::attention_core", "stvd_torch::logit_tail"]
    for flag, words in (("--data-parallel", "only 1 visible"),
                        ("--model-parallel", "needs 2 devices; 1 visible")):
        with pytest.raises(ValueError, match=words):
            texport.main(["--run-dir", tdir, "--out", str(tmp_path / "x"),
                          "--platforms", "cpu", "--device", "cpu", flag,
                          "2", "--batch", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        texport.main(["--run-dir", tdir, "--out", str(tmp_path / "y")])
