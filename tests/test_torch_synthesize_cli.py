"""The port's ``synthesize`` command against the JAX package's, on the CPU.

A stubbed JAX model (f32) is exported to a Lightning .ckpt for the port;
the JAX CLI reads the orbax directory. Both CLIs synthesize one filelist
(a line long enough to chunk, batches of 2) for ``-O spec textgrid
readalong-xml`` and for ``-v griffin-lim -O wav readalong-html``: the same
file names, specs within max-abs 1e-4, TextGrids and ReadAlongs byte-equal,
wavs within 2 PCM16 steps, and the HTML pages byte-equal but for the
embedded wav, which is held to the same 2 steps. (Griffin-Lim, because the
stub HiFiGAN's ~1e-6 amplitude is all zeros in PCM16; the port's HiFiGAN
path writes a wav of the spec's length.) Teacher forcing on a workspace the
JAX package preprocessed, against JAX ``synthesize_items(teacher_forcing=
True)``: MAS durations equal, specs within 1e-4 and of the target mel
lengths, TextGrids byte-equal. The usage errors exit 2 with the JAX CLI's
messages. ``Synthesizer.from_checkpoint(vocoder_path="griffin-lim")``
vocodes, and the port's server answers wav with it."""

import base64
import contextlib
import io
import json
import re
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from scipy.io import wavfile

from fastspeech2_lightning_tpu.cli import app as jax_app
from fastspeech2_lightning_tpu.models.torch_export import export_reference_lightning_checkpoint
from fastspeech2_lightning_tpu.synthesis.prepare import prepare_data as j_prepare_data
from fastspeech2_lightning_tpu.synthesis.synthesize import (
    load_model_from_checkpoint as j_load_model_from_checkpoint,
)
from fastspeech2_lightning_tpu.synthesis.synthesize import synthesize_items as j_synthesize_items
from fastspeech2_lightning_tpu.synthesis.writers import (
    get_synthesis_output_writers as j_get_writers,
)
from fastspeech2_lightning_tpu.testing import get_stubbed_model, get_stubbed_vocoder, stub_config
from fastspeech2_lightning_tpu.type_definitions import SynthesizeOutputFormats as JFormats
from fastspeech2_lightning_tpu_torch import cli
from fastspeech2_lightning_tpu_torch.checkpoint import load_model_from_checkpoint
from fastspeech2_lightning_tpu_torch.serving.server import SynthesisServer
from fastspeech2_lightning_tpu_torch.synthesis.api import Synthesizer
from fastspeech2_lightning_tpu_torch.synthesis.griffin_lim import GriffinLimVocoder
from fastspeech2_lightning_tpu_torch.synthesis.prepare import prepare_data
from fastspeech2_lightning_tpu_torch.synthesis.synthesize import synthesize_items

from helpers import make_training_workspace

torch.set_num_threads(2)
SPEC_ATOL = 1e-4
PCM_STEPS = 2
RUNS = {
    "aligned text": (["-O", "spec", "-O", "textgrid", "-O", "readalong-xml"], []),
    "griffin-lim": (["-O", "wav", "-O", "readalong-html"], ["-v", "griffin-lim"]),
}
LINES = ["hello world, how are you today",
         "the quick brown fox jumps over the lazy dog. then it runs away, far from here",
         "quiet evening"]


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stub")
    _, orbax_dir = get_stubbed_model(tmp / "model", config=stub_config(dtype="float32"))
    _, voc = get_stubbed_vocoder(tmp / "voc")
    ckpt = export_reference_lightning_checkpoint(orbax_dir, tmp / "model.ckpt")
    filelist = tmp / "list.psv"
    filelist.write_text("basename|speaker|language|characters\n" + "".join(
        f"u{i}|default|default|{line}\n" for i, line in enumerate(LINES)))
    return tmp, orbax_dir, ckpt, voc, filelist


def _port_cli(argv):
    """(exit code, stderr) of the port's CLI in this process."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(argv)
        except SystemExit as e:
            return e.code, err.getvalue()
    return 0, err.getvalue()


def _files(root):
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request, stub):
    tmp, orbax_dir, ckpt, _, filelist = stub
    formats, vocoder = RUNS[request.param]
    out_j, out_p = tmp / f"jax-{request.param}", tmp / f"port-{request.param}"
    res = CliRunner().invoke(jax_app, ["synthesize", str(orbax_dir), "-f", str(filelist),
                                       "-b", "2", "-o", str(out_j), *formats, *vocoder],
                             catch_exceptions=False)
    assert res.exit_code == 0, res.output
    code, err = _port_cli(["synthesize", str(ckpt), "-f", str(filelist), "-b", "2",
                           "-o", str(out_p), "--device", "cpu", *formats, *vocoder])
    assert code == 0, err
    return request.param, _files(out_j), _files(out_p)


def _pcm(data: bytes) -> np.ndarray:
    sr, pcm = wavfile.read(io.BytesIO(data))
    assert sr == 22050
    return pcm.astype(np.int64)


AUDIO = re.compile(rb'src="data:audio/wav;base64,([^"]*)"')


def test_same_files_as_the_jax_cli(runs):
    name, want, got = runs
    assert sorted(got) == sorted(want)
    per_format = 2 if name == "griffin-lim" else 3
    assert len(got) == per_format * len(LINES)  # the chunked line is one file
    for path, f in got.items():
        if path.endswith(".npy"):
            np.testing.assert_allclose(np.load(f), np.load(want[path]), rtol=0, atol=SPEC_ATOL)
        elif path.endswith(".wav"):
            a, b = _pcm(f.read_bytes()), _pcm(want[path].read_bytes())
            assert a.shape == b.shape and a.size > 0
            assert int(np.abs(a - b).max()) <= PCM_STEPS
            assert int(np.abs(b).max()) > 100  # audible
        elif path.endswith(".html"):
            a, b = f.read_bytes(), want[path].read_bytes()
            assert AUDIO.sub(b"", a) == AUDIO.sub(b"", b)
            wa, wb = (_pcm(base64.b64decode(AUDIO.search(x)[1])) for x in (a, b))
            assert wa.shape == wb.shape and int(np.abs(wa - wb).max()) <= PCM_STEPS
        else:
            assert f.read_bytes() == want[path].read_bytes(), path


def test_hifigan_wav_has_the_spec_length(stub):
    tmp, _, ckpt, voc, filelist = stub
    out = tmp / "port-hifigan"
    code, err = _port_cli(["synthesize", str(ckpt), "-f", str(filelist), "-v", str(voc),
                           "-O", "wav", "spec", "-o", str(out), "--device", "cpu"])
    assert code == 0, err
    files = _files(out)
    for i in range(len(LINES)):
        spec = [p for n, p in files.items() if n.endswith(".npy")][i]
        wav = [p for n, p in files.items() if n.endswith(".wav")][i]
        assert wavfile.read(wav)[1].shape == (np.load(spec).shape[1] * 256,)
    assert all("--ckpt=0--v_ckpt=0--pred.wav" in n for n in files if n.endswith(".wav"))


USAGE = {
    "a filelist that does not exist": ["-f", "{filelist}.missing"],
    "neither texts nor filelist": [],
    "both texts and filelist": ["-t", "abc", "-f", "{filelist}"],
    "wav without a vocoder": ["-t", "abc"],
    "readalong-html without a vocoder": ["-t", "abc", "-O", "readalong-html"],
    "phones on a character model": ["-t", "abc", "-O", "spec", "--text-representation",
                                    "phones"],
}


@pytest.mark.parametrize("case", list(USAGE))
def test_usage_errors_match_the_jax_cli(stub, case):
    tmp, orbax_dir, ckpt, _, filelist = stub
    args = [a.format(filelist=filelist) for a in USAGE[case]]
    res = CliRunner().invoke(jax_app, ["synthesize", str(orbax_dir), *args])
    assert res.exit_code == 2
    message = res.output.split("Error: ", 1)[1].strip()
    code, err = _port_cli(["synthesize", str(ckpt), *args, "-o", str(tmp / "usage"),
                           "--device", "cpu"])
    assert code == 2
    assert " ".join(err.split()).endswith("error: " + " ".join(message.split())), err


class _Recorder:
    """A writer that keeps every batch's outputs."""

    def __init__(self):
        self.outputs = []

    def on_predict_batch_end(self, outputs, batch):
        self.outputs.append({k: np.array(v) for k, v in outputs.items()})


@pytest.fixture(scope="module")
def teacher_forced(tmp_path_factory):
    root = tmp_path_factory.mktemp("tf")
    jcfg = make_training_workspace(root, n_utts=5, model_overrides={"dtype": "float32"})
    _, orbax_dir = get_stubbed_model(root / "model", config=jcfg)
    ckpt = export_reference_lightning_checkpoint(orbax_dir, root / "model.ckpt")
    filelist = root / "pre" / "training_filelist.psv"

    model, variables, config, stats, lang2id, speaker2id, _ = j_load_model_from_checkpoint(
        orbax_dir)
    items = j_prepare_data(None, None, None, filelist, config, stats, lang2id, speaker2id,
                           split_text=False)
    jrec = _Recorder()
    writers = j_get_writers([JFormats.spec, JFormats.textgrid], root / "jax", config,
                            "output", 0)
    j_synthesize_items(items, model, variables, config, lang2id, speaker2id,
                       {**writers, "record": jrec}, batch_size=2, teacher_forcing=True)

    pmodel, pconfig, pstats, plang, pspk, _ = load_model_from_checkpoint(ckpt, device="cpu")
    prec = _Recorder()
    synthesize_items(prepare_data(None, None, None, filelist, pconfig, pstats, plang, pspk,
                                  split_text=False),
                     pmodel, pconfig, plang, pspk, {"record": prec}, batch_size=2,
                     teacher_forcing=True)
    code, err = _port_cli(["synthesize", str(ckpt), "-f", str(filelist), "-T",
                           str(root / "pre"), "-O", "spec", "textgrid", "-b", "2",
                           "-o", str(root / "port"), "--device", "cpu"])
    assert code == 0, err
    return root, jrec, prec, items


def test_teacher_forced_durations_equal(teacher_forced):
    _, jrec, prec, items = teacher_forced
    assert len(prec.outputs) == len(jrec.outputs) == 2  # 3 utterances, batches of 2
    for want, got in zip(jrec.outputs, prec.outputs):
        np.testing.assert_array_equal(got["duration_rounded"], want["duration_rounded"])
        np.testing.assert_array_equal(got["tgt_lens"], want["tgt_lens"])
        assert got["output"].shape == want["output"].shape
        np.testing.assert_allclose(got["output"], want["output"], rtol=0, atol=SPEC_ATOL)
    assert len(items) == 3


def test_teacher_forced_on_two_replicas_equals_one(teacher_forced):
    """``synthesize_items(devices=[cpu, cpu])``: each batch's rows split over
    two replicas, the partial last batch filled with its row 0 and trimmed
    before the writers: the one-replica outputs (within JAX's data-parallel
    tolerance, 2e-5; durations equal) and JAX's."""
    root, jrec, prec, _ = teacher_forced
    pmodel, pconfig, pstats, plang, pspk, _ = load_model_from_checkpoint(root / "model.ckpt",
                                                                         device="cpu")
    rec = _Recorder()
    synthesize_items(prepare_data(None, None, None, root / "pre" / "training_filelist.psv",
                                  pconfig, pstats, plang, pspk, split_text=False),
                     pmodel, pconfig, plang, pspk, {"record": rec}, batch_size=2,
                     teacher_forcing=True, devices=["cpu", "cpu"])
    assert [len(o["tgt_lens"]) for o in rec.outputs] == [2, 1]
    for got, one, want in zip(rec.outputs, prec.outputs, jrec.outputs):
        assert set(got) == set(one)
        for key in ("duration_rounded", "tgt_lens", "attn_hard"):
            np.testing.assert_array_equal(got[key], one[key])
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["output"], one["output"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["output"], want["output"], rtol=0, atol=SPEC_ATOL)


def test_teacher_forced_outputs_carry_the_loss_inputs(teacher_forced):
    """The teacher-forced forward returns what JAX's returns for the loss:
    the alignment's log-probabilities, soft and hard alignments, the
    durations as targets; no pitch or energy targets at inference."""
    _, jrec, prec, _ = teacher_forced
    for want, got in zip(jrec.outputs, prec.outputs):
        assert "pitch_target" not in got and "energy_target" not in got
        np.testing.assert_array_equal(got["duration_target"], want["duration_target"])
        np.testing.assert_array_equal(got["attn_hard"], want["attn_hard"])
        np.testing.assert_array_equal(got["src_lens"], want["src_lens"])
        for key in ("attn_soft", "attn_logprob"):
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SPEC_ATOL, err_msg=key)


def test_teacher_forced_cli_files_equal(teacher_forced):
    root, _, _, items = teacher_forced
    want, got = _files(root / "jax"), _files(root / "port")
    # the workspace's utterances all read "ab cd": one file name a format,
    # written by each utterance in turn, as the JAX package writes it
    assert sorted(got) == sorted(want) and len(got) == 2 and len(items) == 3
    for path, f in got.items():
        if path.endswith(".npy"):
            spec = np.load(f)
            # the last utterance wrote it last
            target = np.load(next((root / "pre" / "spec").glob(f"{items[-1]['basename']}--*")))
            assert spec.shape == target.shape  # [n_mels, frames of the target]
            np.testing.assert_allclose(spec, np.load(want[path]), rtol=0, atol=SPEC_ATOL)
        else:
            assert f.read_bytes() == want[path].read_bytes(), path


def test_synthesizer_and_server_vocode_with_griffin_lim(stub):
    _, _, ckpt, _, _ = stub
    syn = Synthesizer.from_checkpoint(ckpt, vocoder_path="griffin-lim", device="cpu")
    assert isinstance(syn.vocoder, GriffinLimVocoder) and syn.vocoder.device.type == "cpu"
    result = syn.synthesize([LINES[0]])
    wav = result.wavs[0]
    assert result.sample_rate == 22050 and wav.shape == (result.mels[0].shape[0] * 256,)
    assert np.isfinite(wav).all() and float(np.abs(wav).max()) > 1e-2
    srv = SynthesisServer(syn, port=0, max_batch=2, global_step=0)
    srv.start()
    try:
        host, port = srv.address[:2]
        req = urllib.request.Request(f"http://{host}:{port}/synthesize",
                                     data=json.dumps({"text": LINES[0]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            body = r.read()
    finally:
        srv.shutdown()
    want = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int64)
    # a streamed wav: its header leaves the data size open
    assert body[:4] == b"RIFF" and body[36:40] == b"data"
    got = np.frombuffer(body[44:], dtype="<i2").astype(np.int64)
    # the server's thread may split the FFTs over other threads: float
    # rounding, held to the wavs' tolerance
    assert got.shape == want.shape and int(np.abs(got - want).max()) <= PCM_STEPS
