"""The port's segmented parallel MP3 encoder (nodey_tpu_torch/host/
encode.py: ``ParallelMp3Encoder``, ``mp3_workers``, ``open_sink``'s rule)
against the JAX package's, on the CPU.

The spliced stream is exact: bit-identical frame for frame to a serial
no-reservoir LAME encode of the same PCM (tests/test_parallel_mp3.py). Here
the port's file is also byte-identical to the JAX package's
``ParallelMp3Encoder`` on the same blocks (both drive the same LAME
through their own build of the same codec sources), float and s16 wire;
the Info tag's totals are patched; a short clip is one segment; a rate
that needs LAME's resampler refuses. ``open_sink`` picks the parallel
encoder only with more than one worker and a 48 kHz master, and a streamed
export goes through it end to end, byte-identical to the same master PCM
fed to the encoder directly in other blocks. Workers are forced to 2, so
the thread pool runs on any host (its output does not depend on
scheduling). ``encode_mp3`` writes the JAX package's ``encode_mp3`` bytes
and progress, from a tensor or an array.

The JAX package's codec runtime builds without a lock
(nodey_tpu/host/native_lib.py): test workers that start together can each
build ``build/native/``, and one that meets another's build half done
caches the failure for the rest of its life. ``jax_codec_runtime`` waits
until the library stands still, clears that cached failure and loads it
again, so the comparison runs against a whole runtime.
"""

import struct
import time
import wave

import numpy as np
import pytest
import torch

from nodey_tpu.host import encode as jencode
from nodey_tpu.host import native_lib as jnative
from nodey_tpu_torch.core import registry
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.core.graph import Graph
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host import encode
from nodey_tpu_torch.processors.audio_input import AudioInput
from nodey_tpu_torch.processors.audio_output import AudioOutput
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

RATE = 48_000


@pytest.fixture(autouse=True)
def codec_runtime():
    if host_decode.load_native() is None:
        pytest.skip("the codec runtime does not build on this machine")


def jax_codec_runtime(monkeypatch, timeout=180.0):
    """The JAX package's codec runtime, loaded whole: wait until
    ``build/native/libnodey_host.so`` has not changed for a second (or is
    absent, and the loader builds it), clear the loader's cached failure
    and load; a failed load is retried until ``timeout`` seconds."""
    so = jnative._BUILD_DIR / "libnodey_host.so"
    deadline = time.monotonic() + timeout
    while jnative._lib is None:
        try:
            before = so.stat()
            time.sleep(1.0)
            after = so.stat()
            still = (before.st_size, before.st_mtime_ns) == (
                after.st_size, after.st_mtime_ns)
        except FileNotFoundError:
            still = True
        if still:
            monkeypatch.setattr(jnative, "_load_failed", None)
            try:
                jnative.load()
            except OSError:
                pass
        if jnative._lib is None and time.monotonic() > deadline:
            pytest.fail(f"the JAX package's codec runtime did not load "
                        f"within {timeout} s: {jnative._load_failed}")
    return jnative._lib


def _noise(seconds, seed=3):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((2, int(RATE * seconds)))).astype(
        np.float32)


def _feed(enc, x, blk=RATE * 3):
    for s in range(0, x.shape[1], blk):
        enc.write(x[:, s:s + blk])
    enc.close()


def _frames(path):
    data = open(path, "rb").read()
    return data, [data[o:o + s] for o, s in encode._mp3_frames(data)]


def test_parallel_mp3_is_the_jax_encoders_bytes(tmp_path, monkeypatch):
    jax_codec_runtime(monkeypatch)
    x = _noise(12.0)
    ints = np.clip(np.trunc(x * 32768.0), -32768, 32767).astype(np.int16)
    for fmt, pcm in (("flt", x), ("s16", ints)):
        ser, par, jpar = (str(tmp_path / f"{n}_{fmt}.mp3")
                          for n in ("ser", "par", "jpar"))
        _feed(encode.Mp3Encoder(ser, RATE, 2, 192, fmt, flags=2), pcm)
        _feed(encode.ParallelMp3Encoder(par, RATE, 2, 192, fmt, workers=2,
                                        seg_seconds=4.0), pcm, 10_000)
        _feed(jencode.ParallelMp3Encoder(jpar, RATE, 2, 192, fmt, workers=2,
                                         seg_seconds=4.0), pcm, 10_000)
        data, frames = _frames(par)
        assert data == open(jpar, "rb").read(), fmt
        _, serial = _frames(ser)
        assert len(frames) == len(serial) and frames[1:] == serial[1:], fmt
        # The Info tag's totals describe the spliced file.
        tag = frames[0]
        assert encode._is_info_tag(tag) and jencode._is_info_tag(tag)
        magic = max(tag.find(b"Info"), tag.find(b"Xing"))
        assert struct.unpack_from(">I", tag, magic + 4)[0] & 3 == 3
        assert struct.unpack_from(">I", tag, magic + 8)[0] == len(frames) - 1
        assert struct.unpack_from(">I", tag, magic + 12)[0] == len(data)
        assert encode._tag_encoder_delay(tag) \
            == jencode._tag_encoder_delay(tag) > 0
        assert list(encode._mp3_frames(data)) \
            == list(jencode._mp3_frames(data))
        patched = encode._patch_info_tag(bytearray(tag), 7, 9_999, 123)
        assert patched == jencode._patch_info_tag(bytearray(tag), 7, 9_999,
                                                  123)
        a, b = host_decode.decode_file(ser), host_decode.decode_file(par)
        assert a.num_samples == b.num_samples
        np.testing.assert_array_equal(a.data, b.data)
        # One call, from a tensor (flt) or an array (s16), with progress.
        one, jone = (str(tmp_path / f"{n}_{fmt}.mp3") for n in ("one", "jone"))
        seen, jseen = [], []
        encode.encode_mp3(one, torch.from_numpy(pcm) if fmt == "flt" else pcm,
                          RATE, 192, fmt, progress=seen.append)
        jencode.encode_mp3(jone, pcm, RATE, 192, fmt, progress=jseen.append)
        assert open(one, "rb").read() == open(jone, "rb").read(), fmt
        assert seen == jseen and seen[-1] == pcm.shape[1] / RATE

    short = _noise(1.2, seed=9)
    path = str(tmp_path / "short.mp3")
    _feed(encode.ParallelMp3Encoder(path, RATE, 2, 192, workers=2), short,
          4096)
    d = host_decode.decode_file(path)
    assert abs(d.num_samples - short.shape[1]) <= 1152 * 2
    assert np.isfinite(d.data).all()

    with pytest.raises(ProcessorRuntimeError) as err:
        encode.ParallelMp3Encoder(str(tmp_path / "x.mp3"), 44_100, 2, 192)
    assert "in_rate == out_rate" in err.value.message


def test_open_sink_rule_and_the_streamed_export(tmp_path, monkeypatch):
    monkeypatch.setenv("NODEY_MP3_WORKERS", "4")
    assert encode.mp3_workers() == 4
    picks = []
    for name, rate in (("a.mp3", RATE), ("b.mp3", 44_100), ("d.wav", RATE)):
        sink = encode.open_sink(str(tmp_path / name), rate, 2, 192, "flt")
        picks.append(type(sink).__name__)
        sink.close()
    monkeypatch.setenv("NODEY_MP3_WORKERS", "1")
    sink = encode.open_sink(str(tmp_path / "c.mp3"), RATE, 2, 192, "flt")
    picks.append(type(sink).__name__)
    sink.close()
    assert picks == ["ParallelMp3Encoder", "Mp3Encoder", "WavWriter",
                     "Mp3Encoder"]
    monkeypatch.setenv("NODEY_MP3_WORKERS", "x")
    assert encode.mp3_workers() == jencode.mp3_workers() == 1

    registry.register_all_processors()
    wav = tmp_path / "in.wav"
    host_decode.write_wav_s16(str(wav), _noise(10.0), RATE)

    def build():
        g = Graph()
        src = g.add_node(AudioInput())
        g.nodes[src].processor.file_paths = [str(wav)]
        g.update_node_pin(src)
        out = g.add_node(AudioOutput())
        g.add_link(g.nodes[src].pin_name_map["output_0"],
                   g.nodes[out].pin_name_map["input"])
        return g

    used, real_open = [], encode.open_sink

    def spy_open(*a, **k):
        sink = real_open(*a, **k)
        used.append(type(sink).__name__)
        return sink

    monkeypatch.setattr(encode, "open_sink", spy_open)
    monkeypatch.setenv("NODEY_MP3_WORKERS", "2")
    out = tmp_path / "streamed.mp3"
    metrics = Runner(build(), device="cpu").export_streamed(str(out),
                                                            kbps=192)
    assert metrics.audio_seconds > 9.0
    assert used == ["ParallelMp3Encoder"]
    master = tmp_path / "master.wav"
    Runner(build(), device="cpu").export_streamed(str(master), kbps=192)
    with wave.open(str(master), "rb") as wf:
        assert wf.getframerate() == RATE and wf.getnchannels() == 2
        raw = np.frombuffer(wf.readframes(wf.getnframes()), dtype=np.int16
                            ).reshape(-1, 2).T.copy()
    direct = tmp_path / "direct.mp3"
    _feed(encode.ParallelMp3Encoder(str(direct), RATE, 2, 192, "s16",
                                    workers=2), raw, RATE // 2 + 331)
    assert out.read_bytes() == direct.read_bytes()
    assert encode._is_info_tag(_frames(str(out))[1][0])
