"""The port's TensorBoard event files (``utils/tensorboard.py``) against
``tensorboard`` and ``tensorboardX``, which this test alone imports.

The CRC-32C and its TFRecord mask equal the pure-Python ones of tensorboard's
TensorFlow stub; a file the port writes (scalars, an image, an audio clip)
reads through tensorboard's ``EventAccumulator`` with the same tags, steps
and values, its PNG decodes with PIL to the array written and its WAV with
scipy to the clipped PCM16 of the input; a file tensorboardX writes reads
through the port's ``read_events``; and a flipped byte makes ``read_events``
raise."""

import io

import numpy as np
import pytest
from PIL import Image
from scipy.io import wavfile
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c as tb_masked_crc
from tensorboardX import SummaryWriter as TBXWriter

from fastspeech2_lightning_tpu_torch.utils import tensorboard as tb

SIZES = [0, 1, 7, 8, 9, 1023, 2048, 2049, 8191, 65536, 100_000]


@pytest.mark.parametrize("n", SIZES)
def test_crc32c_equals_tensorboards(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tb.masked_crc32c(data) == tb_masked_crc(data)
    c = tb.crc32c(data)
    assert tb.masked_crc32c(data) == (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def test_crc32c_of_the_check_string():
    """The standard check value of CRC-32C."""
    assert tb.crc32c(b"123456789") == 0xE3069283


@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    """A port-written file: two scalars at three steps, an image, an audio
    clip that runs past [-1, 1]."""
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (13, 21, 3), dtype=np.uint8)
    audio = (rng.standard_normal(4001) * 0.6).astype(np.float32)
    scalars = {"training/total_loss": [(1, 3.25), (50, 2.5), (100, float("nan"))],
               "validation/total_loss": [(100, 1.0e-7)]}
    logdir = tmp_path_factory.mktemp("tb")
    with tb.SummaryWriter(logdir) as writer:
        for tag, points in scalars.items():
            for step, value in points:
                writer.add_scalar(tag, value, step)
        writer.add_image("pred/spec_x", image, 7)
        writer.add_audio("pred/wav_x", audio, 7, 22050)
    (path,) = logdir.glob("events.out.tfevents.*")
    return path, scalars, image, audio


def test_file_name_and_first_record(port_file):
    path = port_file[0]
    assert path.name.split(".")[:3] == ["events", "out", "tfevents"]
    assert len(path.name.split(".")[3]) == 10 and path.name.split(".")[3].isdigit()
    first = tb.read_events(path)[0]
    assert first["file_version"] == "brain.Event:2" and first["wall_time"] > 1e9


def test_port_file_reads_in_tensorboards_event_accumulator(port_file):
    path, scalars, image, audio = port_file
    acc = EventAccumulator(str(path), size_guidance={"scalars": 0, "images": 0, "audio": 0})
    acc.Reload()
    tags = acc.Tags()
    assert sorted(tags["scalars"]) == sorted(scalars)
    assert tags["images"] == ["pred/spec_x"] and tags["audio"] == ["pred/wav_x"]
    for tag, points in scalars.items():
        got = [(e.step, e.value) for e in acc.Scalars(tag)]
        want = [(s, float(np.float32(v))) for s, v in points]
        assert [s for s, _ in got] == [s for s, _ in want]
        np.testing.assert_array_equal([v for _, v in got], [v for _, v in want])
    (img,) = acc.Images("pred/spec_x")
    assert (img.step, img.height, img.width) == (7, 13, 21)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(img.encoded_image_string))),
                                  image)
    np.testing.assert_array_equal(tb.decode_png(img.encoded_image_string), image)
    (clip,) = acc.Audio("pred/wav_x")
    assert (clip.step, clip.sample_rate, clip.length_frames, clip.content_type) == (
        7, 22050.0, audio.size, "audio/wav")
    sr, pcm = wavfile.read(io.BytesIO(clip.encoded_audio_string))
    want = np.round(np.clip(audio.astype(np.float64), -1, 1) * 32767).astype(np.int16)
    assert sr == 22050 and pcm.dtype == np.int16 and np.abs(audio).max() > 1
    np.testing.assert_array_equal(pcm, want)
    np.testing.assert_array_equal(tb.wav_samples(clip.encoded_audio_string)[0], want)


def test_port_reader_reads_its_own_file(port_file):
    path, scalars, image, audio = port_file
    events = tb.read_events(path)
    got = tb.scalars(events)
    assert list(got) == list(scalars)
    for tag, points in scalars.items():
        np.testing.assert_array_equal(np.array(got[tag]),
                                      np.array([(s, np.float32(v)) for s, v in points]))
    media = [(e["step"], v) for e in events for v in e.get("summary", ())
             if "simple_value" not in v]
    assert [(s, v["tag"]) for s, v in media] == [(7, "pred/spec_x"), (7, "pred/wav_x")]
    assert media[0][1]["image"]["colorspace"] == 3
    assert media[1][1]["audio"]["num_channels"] == 1


def test_tensorboardx_file_reads_through_the_port_reader(tmp_path):
    rng = np.random.default_rng(1)
    image = rng.integers(0, 256, (9, 17, 3), dtype=np.uint8)
    writer = TBXWriter(logdir=str(tmp_path))
    for step, value in ((1, 0.5), (50, 0.25), (100, -3.0)):
        writer.add_scalar("training/grad_norm", value, step)
    writer.add_image("attention/u", image, 3, dataformats="HWC")
    writer.close()
    (path,) = tmp_path.glob("events.out.tfevents.*")
    events = tb.read_events(path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert tb.scalars(events) == {"training/grad_norm": [(1, 0.5), (50, 0.25), (100, -3.0)]}
    (img,) = [(e["step"], v["image"]) for e in events for v in e.get("summary", ())
              if "image" in v]
    assert img[0] == 3 and (img[1]["height"], img[1]["width"], img[1]["colorspace"]) == (9, 17, 3)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(img[1]["encoded_image_string"]))), image)


@pytest.mark.parametrize("where", ["length", "data", "crc"])
def test_a_flipped_byte_makes_the_reader_raise(port_file, tmp_path, where):
    data = bytearray(port_file[0].read_bytes())
    n = int.from_bytes(data[:8], "little")  # the first record's length
    at = {"length": 2, "data": 12 + n // 2, "crc": 12 + n + 1}[where]
    data[at] ^= 0x10
    bad = tmp_path / "events.out.tfevents.bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC|cut short"):
        tb.read_events(bad)


def test_a_cut_file_makes_the_reader_raise(port_file, tmp_path):
    bad = tmp_path / "events.out.tfevents.cut"
    bad.write_bytes(port_file[0].read_bytes()[:-3])
    with pytest.raises(ValueError, match="cut short|CRC"):
        tb.read_events(bad)
