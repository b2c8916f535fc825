"""The port's convolution reverb (nodey_tpu_torch/ops/reverb.py,
processors/reverb.py) against the JAX package's, on the CPU.

- The IR synthesis and the partition spectra are the JAX package's,
  bitwise (they are the node's weights);
- ``partitioned_conv`` > 110 dB against float64 direct convolution (the
  JAX test's mirror and bar, tests/test_reverb.py:83) and against the JAX
  op;
- the node against the JAX node and the float64 oracle (> 100 dB,
  tests/test_reverb.py's node bar), its output grown by L - 1 with exact
  zeros past it; wet 0 with dry 1 a bitwise passthrough, offline and
  streamed;
- streamed through the chunk flow > 90 dB against offline, at the length
  N + L - 1 (tests/test_reverb.py:154); ``render_chunked`` > 110 dB
  against the offline render at the same length (tests/test_reverb.py:179:
  its halo covers the IR and its chunks the tail);
- serde, ``param_spec``, ``hop`` and ``receptive_seconds`` equal the JAX
  node's;
- bench.py's config 7 at 2 s against the JAX render.
Rates of 8 kHz keep the IRs short, as the JAX tests do.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from conftest import snr_db
from nodey_tpu.core import compiler as jcompiler
from nodey_tpu.ops import reverb as jrv
from nodey_tpu.processors.reverb import AudioReverb as JReverb
from nodey_tpu_torch.convert import graph_from_jax
from nodey_tpu_torch.core import streaming
from nodey_tpu_torch.core.runner import Runner
from nodey_tpu_torch.core.stream import Stream
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.ops import reverb as rv
from nodey_tpu_torch.processors.reverb import AudioReverb
from test_reverb import _partitions, direct_conv
from test_torch_effects import (edited, jlower, lower, noise, offline,
                                one_node_graph, streamed)
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

RATE = 8_000


@pytest.mark.parametrize("rate,channels,decay,pre,damping", [
    (8_000, 2, 0.3, 25.0, 0.5), (8_000, 1, 0.4, 0.0, 0.3),
    (48_000, 2, 1.8, 20.0, 0.5), (44_100, 2, 1.2, 20.0, 0.5),
])
def test_ir_and_partitions_equal_the_jax_package(rate, channels, decay, pre,
                                                 damping):
    ir = rv.design_ir(rate, channels, decay, pre, damping)
    np.testing.assert_array_equal(
        ir, jrv.design_ir(rate, channels, decay, pre, damping))
    hr, hi, ln = rv.ir_partitions(rate, channels, decay, pre, damping)
    jhr, jhi, jln = jrv.ir_partitions(rate, channels, decay, pre, damping)
    np.testing.assert_array_equal(hr, jhr)
    np.testing.assert_array_equal(hi, jhi)
    assert ln == jln == rv.ir_length(rate, decay, pre) == \
        jrv.ir_length(rate, decay, pre) == ir.shape[1]
    thr, thi = rv.partitions(rate, channels, decay, pre, damping, "cpu")
    np.testing.assert_array_equal(thr.numpy(), hr)
    np.testing.assert_array_equal(thi.numpy(), hi)


def test_dft_bases_equal_the_jax_package():
    for got, want in zip(rv._fwd_mats(), jrv._fwd_mats()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rv._inv_mat(), jrv._inv_mat())


@pytest.mark.parametrize("n", [1_500, 6_000])
def test_partitioned_conv_matches_float64_and_the_jax_op(n):
    """Multi-partition (K > 1) overlap-save against float64 direct
    convolution (tests/test_reverb.py's mirror, > 110 dB) and against the
    JAX op on the same spectra."""
    x = noise(n)
    ir = rv.design_ir(RATE, 2, 0.4, 0.0, 0.3)
    assert ir.shape[1] > rv.PARTITION            # K >= 2
    hr, hi = _partitions(ir)
    out_len = n + ir.shape[1] - 1
    got = rv.partitioned_conv(torch.from_numpy(x), torch.from_numpy(hr),
                              torch.from_numpy(hi), out_len).numpy()
    ref = direct_conv(x, ir)[:, :out_len].astype(np.float32)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 110.0
    want = np.asarray(jrv.partitioned_conv(jnp.asarray(x), hr, hi, out_len))
    assert snr_db(want, got) > 110.0


def test_node_matches_the_jax_node_and_the_float64_oracle():
    """tests/test_reverb.py::test_offline_node_tail_and_mix in the port:
    the length grows by exactly L - 1, the mix matches the oracle and the
    JAX node > 100 dB, padding past the grown length is exact zeros."""
    x = noise(4_000)
    params = dict(decay_s=0.3, pre_delay_ms=10.0, wet=0.4, dry=0.8)
    node, jnode = edited(AudioReverb, **params), edited(JReverb, **params)
    ir = rv.design_ir(RATE, 2, 0.3, 10.0, node.damping)
    out = lower(node, x)
    assert out.length == x.shape[1] + ir.shape[1] - 1
    want, want_len = jlower(jnode, x)
    got = out.data.numpy()
    assert got.shape == want.shape and want_len == out.length
    ref = 0.8 * np.pad(x, ((0, 0), (0, ir.shape[1] - 1))) \
        + 0.4 * direct_conv(x, ir)
    assert snr_db(ref.astype(np.float32), got[:, :out.length]) > 100.0
    assert snr_db(want, got) > 100.0
    assert not got[:, out.length:].any()
    # A Stream whose samples past its length are not zero: masked first.
    y = x.copy()
    y[:, 3_000:] = 0.7
    short = node.lower(None, {"input": Stream(
        data=torch.from_numpy(y), length=3_000, rate=RATE,
        channels=2)})["output"]
    assert short.length == 3_000 + ir.shape[1] - 1
    full = lower(node, x[:, :3_000]).data.numpy()
    np.testing.assert_allclose(short.data.numpy()[:, :short.length],
                               full[:, :short.length], rtol=0, atol=1e-6)


def test_wet0_is_a_bitwise_passthrough_offline_and_streamed():
    x = noise(4_000)
    node = edited(AudioReverb, wet=0.0, dry=1.0)
    np.testing.assert_array_equal(lower(node, x).data.numpy(), x)
    g, src = one_node_graph(node)
    np.testing.assert_array_equal(offline(g, src, x), x)
    np.testing.assert_array_equal(streamed(g, src, x), x)
    assert node.hop == 0 and node.receptive_seconds == 0.0
    # The dry-only branch (wet 0, dry below 1): the JAX node's values.
    node = edited(AudioReverb, wet=0.0, dry=0.5)
    want = jlower(edited(JReverb, wet=0.0, dry=0.5), x)[0]
    np.testing.assert_array_equal(lower(node, x).data.numpy(), want)
    g, src = one_node_graph(node)
    np.testing.assert_array_equal(streamed(g, src, x), want)


def test_streamed_equals_offline():
    """The tail carried across chunks and flushed after EOF, the total
    length exact (N + L - 1), > 90 dB (the streamed hop grid re-anchors
    per chunk, tests/test_reverb.py:154)."""
    x = noise(6_000, seed=5)
    node = edited(AudioReverb, decay_s=0.25, pre_delay_ms=0.0, wet=0.5,
                  dry=0.6)
    g, src = one_node_graph(node)
    off = offline(g, src, x)
    got = streamed(g, src, x, chunk=2_048)
    assert got.shape == off.shape == \
        (2, x.shape[1] + rv.ir_length(RATE, 0.25, 0.0) - 1)
    assert snr_db(off, got) > 90.0


def test_stream_step_flushes_the_tail_and_counts_down():
    """The op's step alone: a ragged chunk, then flush steps that ship the
    IR tail (``rem`` counts down on the host) and end with done."""
    hr, hi = rv.reverb_stream_prepare(RATE, 2, 0.25, 0.0, 0.5, "cpu")
    ir_len = rv.ir_length(RATE, 0.25, 0.0)
    params = (hr, hi, ir_len, 0.5, 0.6)
    state = rv.reverb_stream_init(2, 1_024, ir_len, 0.5, "cpu")
    assert state[0].shape == (2, rv.stream_ring_len(1_024, ir_len))
    x = torch.from_numpy(noise(1_024))
    state, out, n, done = rv.reverb_stream_step(params, state, x, 700, True)
    assert (n, done, state[1]) == (700, False, ir_len - 1)
    assert not out[:, 700:].any()
    shipped = 0
    while not done:
        state, out, n, done = rv.reverb_stream_step(
            params, state, torch.zeros((2, 1_024)), 0, True)
        assert not out[:, n:].any()
        shipped += n
    assert shipped == ir_len - 1 and state[1] == 0


def test_render_chunked_covers_the_halo_and_the_tail(tmp_path):
    """The chunked renderer sizes its halo from ``receptive_seconds`` and
    renders chunks past the input's end until the tail is out: the same
    length as the offline render, > 110 dB against it
    (tests/test_reverb.py:179)."""
    path = str(tmp_path / "in.wav")
    host_decode.write_wav_s16(path, noise(12_000, seed=8), RATE)
    node = edited(AudioReverb, decay_s=0.2, pre_delay_ms=0.0, wet=0.5,
                  dry=0.5)
    g, _ = one_node_graph(node, [path])
    res = Runner(g, device="cpu").render()
    master, out_rate, _fmt, _spectra = streaming.render_chunked(
        g, chunk_seconds=0.5, device="cpu")
    assert out_rate == res.rate
    assert master.shape == res.master.shape == \
        (2, 12_000 + rv.ir_length(RATE, 0.2, 0.0) - 1)
    assert snr_db(res.master, master) > 110.0


@pytest.mark.parametrize("params", [
    {}, dict(decay_s=0.3, pre_delay_ms=10.0, wet=0.4, dry=0.8),
    dict(wet=0.0, dry=0.6), dict(decay_s=1e9, pre_delay_ms=-5.0, wet=2.0),
])
def test_serde_param_spec_hop_and_receptive_field_equal_the_jax_node(params):
    node, jnode = edited(AudioReverb, **params), edited(JReverb, **params)
    for src, dst in ((node, JReverb()), (jnode, AudioReverb())):
        blob = src.serialize()
        dst.deserialize(json.loads(json.dumps(blob)))
        assert json.dumps(dst.serialize()) == json.dumps(blob)
        assert dst.param_spec() == src.param_spec()
        assert dst.snapshot_params() == src.snapshot_params()
        assert (dst.hop, dst.receptive_seconds) == \
            (src.hop, src.receptive_seconds)
        assert (dst.info().identifier, dst.info().display_name,
                dst.info().description) == \
            (src.info().identifier, src.info().display_name,
             src.info().description)
        assert [(a.identifier, a.display_name, a.is_input)
                for a in dst.pin_attributes()] == \
            [(a.identifier, a.display_name, a.is_input)
             for a in src.pin_attributes()]


def test_config7_matches_the_jax_render(tmp_path, monkeypatch):
    """bench.py's config 7 (one 48 kHz stereo track -> audio_reverb decay
    1.8 s, wet 0.35 -> export) on its 2 s tone: the port's render on the
    CPU > 100 dB (the node's bar) against the JAX render, grown by the
    87,360-sample IR's tail."""

    def write_tracks(tmp, count, seconds, rate, channels):
        n = int(rate * seconds)
        paths = []
        for i in range(count):
            path = f"{tmp}/track{i}.wav"
            host_decode.write_wav_s16(
                path, bench._tone(n, rate, 220.0 * (i + 1), channels, i), rate)
            paths.append(path)
        return paths

    monkeypatch.setattr(bench, "_write_tracks", write_tracks)
    jg, mode = bench.config7_reverb(str(tmp_path), 2.0)
    tg = graph_from_jax(jg)
    runner = Runner(tg, device="cpu")
    arrays, lengths, sources = runner.decode()
    jsources = {key: jcompiler.SourceSpec(
        rate=s.rate, channels=s.channels, fmt=s.fmt, capacity=s.capacity,
        t0_us=s.t0_us) for key, s in sources.items()}
    data, length = jcompiler.compile_graph(jg, jsources, mode=mode).run(
        arrays, lengths)["master"]
    want = np.asarray(data)[:, :int(length)]
    got = runner.render(mode)
    assert (got.rate, got.fmt) == (48_000, "flt")
    assert got.master.shape == want.shape == (2, 2 * 48_000 + 87_360 - 1)
    assert np.isfinite(got.master).all()
    assert snr_db(want, got.master) > 100.0


def test_dft_gemms_run_in_full_float32():
    """The convolution's GEMMs go through the scan engine's checked matmul:
    under any lower matmul precision (TF32) they refuse to run."""
    x = torch.from_numpy(noise(3_000))
    hr, hi = rv.partitions(RATE, 2, 0.3, 0.0, 0.5, "cpu")
    rv.partitioned_conv(x, hr, hi, 4_096)
    previous = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full float32"):
            rv.partitioned_conv(x, hr, hi, 4_096)
    finally:
        torch.set_float32_matmul_precision(previous)
