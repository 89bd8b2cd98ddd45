"""The port's package-level surface, logging, profiler and translate client
on the CPU, against the JAX package's.

- Every public name of ``ctranslate2_tpu`` (and the reference list of
  ``tests/test_api_surface.py``) exists in ``ctranslate2_tpu_torch``, but
  ``get_tpu_device_count``, which has no counterpart on a CUDA card.
- The log level round trip and ``CT2TPU_VERBOSE``; the supported compute
  types; ``contains_model``; the random seed; ``get_cuda_device_count``;
  ``MpiInfo`` and ``get_device_info`` with and without a process group;
  ``DataType``, ``Device``, ``specs`` and the ``models`` namespace; the
  converter classes and the converters' console scripts.
- ``cli.translate.main`` writes the file the JAX package's client writes on
  a builder model (``--device cpu``); ``--log_profiling`` prints the
  profiler's table; without ``--device`` it wants the card.
"""

import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import ctranslate2_tpu as ct
from ctranslate2_tpu.cli import translate as jcli
from ctranslate2_tpu.converters.builder import build_seq2seq_model
import ctranslate2_tpu_torch as tt
from ctranslate2_tpu_torch.cli import translate as tcli
from ctranslate2_tpu_torch.utils import profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXCLUDED = {"get_tpu_device_count"}


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return build_seq2seq_model(str(tmp_path_factory.mktemp("s2s")), vocab_size=128,
                               num_layers=2, num_heads=4, d_model=64, d_ff=128)


@pytest.fixture(scope="module")
def text_files(tmp_path_factory):
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("text")
    src = [" ".join(f"tok{i}" for i in rng.integers(0, 125, rng.integers(3, 15)))
           for _ in range(11)]
    tgt = [" ".join(f"tok{i}" for i in rng.integers(0, 125, rng.integers(2, 9)))
           for _ in range(11)]
    (d / "src.txt").write_text("\n".join(src) + "\n", encoding="utf-8")
    (d / "tgt.txt").write_text("\n".join(tgt) + "\n", encoding="utf-8")
    return str(d / "src.txt"), str(d / "tgt.txt")


def _public(module):
    """The public names of ``module`` but its submodules, which come and go
    as other code imports them."""
    return {n for n in dir(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), types.ModuleType)}


def test_package_exports():
    names = [
        "AsyncGenerationResult", "AsyncScoringResult",
        "AsyncTranslationResult", "DataType", "Device", "Encoder",
        "EncoderForwardOutput", "ExecutionStats", "GenerationResult",
        "GenerationStepResult", "Generator", "MpiInfo", "ScoringResult",
        "TranslationResult", "Translator", "contains_model",
        "get_cuda_device_count", "get_supported_compute_types",
        "set_random_seed", "get_log_level", "set_log_level",
        "converters", "models", "specs", "__version__",
        "Whisper", "Wav2Vec2", "Wav2Vec2Bert",
        "ContinuousBatcher", "ContinuousTranslator", "ContinuousWhisper",
    ]
    assert [n for n in names if not hasattr(tt, n)] == []
    assert _public(ct) - _public(tt) == EXCLUDED
    assert not set(tt.__all__) - _public(tt)
    assert tt.AsyncTranslationResult is tt.AsyncGenerationResult is tt.AsyncResult
    assert tt.AsyncScoringResult is tt.AsyncResult
    for n in ("Whisper", "Wav2Vec2", "Wav2Vec2Bert", "WhisperGenerationResult",
              "WhisperAlignmentResult"):
        assert getattr(tt.models, n) is getattr(tt, n)
    assert tt.specs.__all__ == ct.specs.__all__
    for n in tt.specs.__all__:
        value = getattr(tt.specs, n)
        if callable(value):
            assert value.__module__.startswith("ctranslate2_tpu_torch."), n
    assert tt.__version__ == ct.__version__


def test_converters_match_the_jax_package():
    names = {n for n in _public(ct.converters) if n.endswith("Converter")}
    assert len(names) == 6 and names == {n for n in _public(tt.converters)
                                         if n.endswith("Converter")}
    for n in names:
        assert getattr(tt.converters, n).__module__.startswith(
            "ctranslate2_tpu_torch.converters."), n


def test_converter_console_scripts():
    """Every converter script of the JAX package has a ``ct2tpu-torch-``
    twin that points at the same function of the port."""
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    theirs = {n: v for n, v in scripts.items() if n.endswith("-converter")
              and not n.startswith("ct2tpu-torch-")}
    assert len(theirs) == 7
    for name, target in theirs.items():
        ours = scripts[name.replace("ct2tpu-", "ct2tpu-torch-", 1)]
        assert ours == target.replace("ctranslate2_tpu.", "ctranslate2_tpu_torch.", 1)
        module, func = ours.split(":")
        assert callable(getattr(__import__(module, fromlist=[func]), func))


def test_datatype_and_device():
    names = [n for n in vars(ct.DataType) if not n.startswith("_")]
    assert names == [n for n in vars(tt.DataType) if not n.startswith("_")]
    assert all(getattr(tt.DataType, n) == getattr(ct.DataType, n) for n in names)
    assert (tt.Device.cpu, tt.Device.cuda) == ("cpu", "cuda")


@pytest.mark.parametrize("level", [logging.DEBUG, logging.INFO, logging.ERROR,
                                   -3, -2, -1, 0, 1, 2, 3])
def test_log_level_round_trip(level):
    before = tt.get_log_level(), ct.get_log_level()
    try:
        tt.set_log_level(level)
        ct.set_log_level(level)
        assert tt.get_log_level() == ct.get_log_level()
    finally:
        tt.set_log_level(before[0])
        ct.set_log_level(before[1])
    assert tt.get_log_level() == before[0]


def test_log_level_from_the_environment():
    code = ("import logging, ctranslate2_tpu_torch as t; "
            "print(t.get_log_level() == logging.INFO, "
            "'jax' in __import__('sys').modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CT2TPU_VERBOSE="1"))
    assert out.stdout.split() == ["True", "False"], out.stderr


def test_supported_compute_types():
    types = tt.get_supported_compute_types("cpu")
    assert types == ct.get_supported_compute_types("cpu")
    assert tt.get_supported_compute_types("cuda") == types
    assert tt.get_supported_compute_types() == types
    assert {"int8", "int8_float16", "float16", "bfloat16"} <= types
    with pytest.raises(ValueError, match="unsupported device"):
        tt.get_supported_compute_types("tpu")


def test_contains_model_seed_and_devices(model_dir, tmp_path):
    assert tt.contains_model(model_dir) and not tt.contains_model(str(tmp_path))
    seed = tt.get_random_seed()
    try:
        tt.set_random_seed(1234)
        assert tt.get_random_seed() == 1234
    finally:
        tt.set_random_seed(seed)
    assert tt.get_cuda_device_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert tt.get_cuda_device_count() == 0


def test_mpi_info_and_device_info(monkeypatch, tmp_path):
    import torch.distributed as dist

    for var in ("OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_LOCALID", "LOCAL_RANK",
                "MPI_LOCALRANKID"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    assert (tt.MpiInfo.getNRanks(), tt.MpiInfo.getCurRank(),
            tt.MpiInfo.getLocalRank()) == (1, 0, 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert tt.MpiInfo.getLocalRank() == 3
    info = tt.get_device_info()
    assert set(info) == set(ct.get_device_info())
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert info["platform"] == ("cuda" if torch.cuda.is_available() else "cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        assert (tt.MpiInfo.getNRanks(), tt.MpiInfo.getCurRank()) == (1, 0)
        assert tt.get_device_info()["process_count"] == 1
    finally:
        dist.destroy_process_group()


def test_parser_matches_the_jax_client():
    ours = vars(tcli.build_parser().parse_args(["--model", "m"]))
    theirs = vars(jcli.build_parser().parse_args(["--model", "m"]))
    assert ours.pop("device") == "cuda" and theirs.pop("device") == "auto"
    assert ours == theirs


def _run(cli, args, out):
    assert cli.main([*args, "--out", out]) == 0
    with open(out, encoding="utf-8") as f:
        return f.read().splitlines()


def _split(lines):
    """(scores, tokens) of ``score ||| tokens`` lines."""
    pairs = [line.split(" ||| ") for line in lines]
    return [float(s) for s, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("args", [
    ["--beam_size", "2"],
    ["--beam_size", "1", "--batch_size", "4", "--read_batch_size", "5"],
    ["--beam_size", "2", "--num_hypotheses", "2", "--with_score"],
    ["--beam_size", "2", "--batch_type", "tokens", "--batch_size", "64",
     "--with_score", "--length_penalty", "0.5"],
    ["--task", "score", "--tgt", "TGT"],
], ids=["beam2", "greedy_windows", "hypotheses_scores", "tokens_batches", "score"])
def test_cli_writes_the_jax_clients_file(model_dir, text_files, tmp_path, args):
    src, tgt = text_files
    args = [a.replace("TGT", tgt) for a in args]
    common = ["--model", model_dir, "--src", src, "--max_decoding_length", "12",
              "--device", "cpu", *args]
    ours = _run(tcli, common, str(tmp_path / "port.txt"))
    theirs = _run(jcli, common, str(tmp_path / "jax.txt"))
    assert len(ours) == len(theirs) and ours
    if "--with_score" in args or "score" in args:
        (s1, t1), (s2, t2) = _split(ours), _split(theirs)
        assert t1 == t2
        np.testing.assert_allclose(s1, s2, atol=1e-4, rtol=1e-4)
    else:
        assert ours == theirs


def test_cli_log_profiling_and_throughput(model_dir, text_files, tmp_path, capsys):
    src, _ = text_files
    tcli.main(["--model", model_dir, "--src", src, "--out", str(tmp_path / "o.txt"),
               "--device", "cpu", "--batch_size", "4", "--max_decoding_length", "8",
               "--log_profiling", "--log_throughput"])
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("Tokens per second: ")
    assert float(err[0].split(": ")[1]) > 0
    assert err[1].split() == ["scope", "calls", "self(ms)", "cum(ms)", "%"]
    row = next(line.split() for line in err if line.startswith("Translator.translate_batch"))
    assert int(row[1]) == 3  # 11 lines in batches of 4
    assert err[-1].startswith("(wall time: ")
    assert not profiler.profiling_enabled()


def test_cli_wants_the_card_by_default(model_dir, text_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--model", model_dir, "--src", text_files[0],
                   "--out", str(tmp_path / "o.txt")])


def test_profiler_scopes_and_trace(tmp_path):
    with profiler.profile("off"):
        pass
    profiler.init_profiling()
    with profiler.profile("outer"):
        with profiler.profile("inner"):
            sum(range(10000))
        with profiler.profile("inner"):
            pass
    assert profiler.profiling_enabled()
    text = profiler.dump_profiling()
    rows = {line.split()[0]: line.split() for line in text.splitlines()[1:-1]}
    assert set(rows) == {"outer", "inner"}
    assert rows["inner"][1] == "2" and rows["outer"][1] == "1"
    assert float(rows["outer"][3]) >= float(rows["inner"][3])  # cumulative
    assert float(rows["outer"][2]) <= float(rows["outer"][3])  # self
    with profiler.trace(str(tmp_path / "trace")):
        torch.ones(64).add_(1)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
