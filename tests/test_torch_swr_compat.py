"""``compat="swr"``: the measured libswresample banks
(nodey_tpu_torch/host/resample_ref.py) through the port's resampler, on
the CPU, against the JAX package and the swr oracle.

In one item (the bars of tests/test_resample.py:131-175):

- ``measure_swr_bank`` and ``bank_spec(..., compat="swr")`` are bitwise the
  JAX package's at every pair of its COMPAT_PAIRS;
- ``resample_data(..., compat="swr")`` >= 90 dB against ``swr_convert`` at
  those pairs (the analytic bank falls far below that at the extreme
  ratios);
- the streamed compat resample (``chunkops.resample_plan(...,
  compat="swr")``) within 3e-7 of the offline compat resample;
- ``run --swr-compat`` exports the 5-node project within 2e-6 of the JAX
  CLI's ``run --swr-compat`` (tests/test_torch_parallel.py's bar for that
  graph) and not as the analytic bank renders it;
- where the codec runtime does not load, a compat render and a compat
  stream plan raise ``ProcessorRuntimeError``: no analytic bank in its
  place.

The JAX package's codec runtime loads only inside the test's body.
"""

import os

import numpy as np
import pytest
import torch

from conftest import snr_db
from nodey_tpu.app import cli as jcli
from nodey_tpu.host import resample_ref as jref
from nodey_tpu.ops import resample as jr
from nodey_tpu_torch.app import cli
from nodey_tpu_torch.core.errors import ProcessorRuntimeError
from nodey_tpu_torch.host import decode as host_decode
from nodey_tpu_torch.host import resample_ref
from nodey_tpu_torch.ops import chunkops
from nodey_tpu_torch.ops import resample as tr
from test_resample import COMPAT_PAIRS, multitone
from test_torch_app import _cli, _project
from test_torch_effects import one_torch_thread  # noqa: F401 (autouse)

SWR_DB = 90.0
STREAM_TOL = 3e-7
MASTER_TOL = 2e-6


def _wav(path):
    return host_decode.decode_file(str(path)).data


def test_swr_banks_render_stream_and_export_as_the_jax_package(
        tmp_path, monkeypatch):
    if host_decode.load_native() is None:
        pytest.skip("the codec runtime does not build on this machine")
    monkeypatch.setenv("NODEY_RESAMPLE_COMPAT", "")

    for in_rate, out_rate in COMPAT_PAIRS:
        mine, theirs = (resample_ref.measure_swr_bank(in_rate, out_rate),
                        jref.measure_swr_bank(in_rate, out_rate))
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert mine[1:] == theirs[1:]
        mine, theirs = (tr.bank_spec(in_rate, out_rate, compat="swr"),
                        jr.bank_spec(in_rate, out_rate, compat="swr"))
        np.testing.assert_array_equal(mine[0], theirs[0])
        assert mine[1:] == theirs[1:]
        x = multitone(in_rate)
        golden = resample_ref.swr_convert(x, in_rate, out_rate)
        got = tr.resample_data(torch.from_numpy(x), in_rate, out_rate,
                               compat="swr").numpy()
        n = min(golden.shape[-1], got.shape[-1])
        assert snr_db(golden[:, 200:n - 200], got[:, 200:n - 200]) >= SWR_DB

    # Streamed against offline, both on the measured bank.
    in_rate, out_rate, chunk = 44_100, 48_000, 4_410
    x = multitone(in_rate, seconds=0.8, channels=2)
    ref = tr.resample_data(torch.from_numpy(x), in_rate, out_rate,
                           compat="swr")
    plan = chunkops.resample_plan(in_rate, out_rate, chunk, "cpu",
                                  compat="swr")
    assert plan.compat == "swr"
    np.testing.assert_array_equal(plan.bank.numpy(), tr.bank_spec(
        in_rate, out_rate, compat="swr")[0])
    state = chunkops.resample_stream_init(plan, 2, "cpu")
    pieces, pos, done = [], 0, False
    while not done:
        block = torch.zeros((2, chunk))
        n = max(min(chunk, x.shape[1] - pos), 0)
        block[:, :n] = torch.from_numpy(x[:, pos:pos + n])
        pos += n
        state, out, out_n, done = chunkops.resample_stream_step(
            plan, state, block, n, pos >= x.shape[1])
        pieces.append(out[:, :out_n])
    got = torch.cat(pieces, dim=1)
    assert abs(got.shape[1] - ref.shape[1]) <= 1
    m = min(got.shape[1], ref.shape[1])
    assert (got[:, :m] - ref[:, :m]).abs().max() <= STREAM_TOL

    # run --swr-compat through both CLIs, and the analytic export beside.
    project, _blob = _project(tmp_path, seconds=0.5)
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        for flag in ("--swr-compat", None):
            monkeypatch.setenv("NODEY_RESAMPLE_COMPAT", "")
            path = tmp_path / f"{name}_{bool(flag)}.wav"
            rc, _out, err = _cli(main, ["run", project, "--export",
                                        str(path), *extra,
                                        *([flag] if flag else [])])
            assert rc == 0, err
            assert (os.environ["NODEY_RESAMPLE_COMPAT"] == "swr") \
                == bool(flag)
            outs[name, bool(flag)] = _wav(path)
    assert outs["port", True].shape == outs["jax", True].shape
    assert np.abs(outs["port", True] - outs["jax", True]).max() <= MASTER_TOL
    assert np.abs(outs["port", True] - outs["port", False]).max() \
        > 100 * MASTER_TOL

    # No codec runtime: the compat paths refuse instead of rendering.
    monkeypatch.setattr(resample_ref, "load_native", lambda: None)
    pair = (24_000, 44_100)                  # measured nowhere above
    with pytest.raises(ProcessorRuntimeError, match="oracle unavailable"):
        tr.resample_data(torch.zeros((2, 4_800)), *pair, compat="swr")
    with pytest.raises(ProcessorRuntimeError, match="oracle unavailable"):
        chunkops.resample_plan(*pair, 4_800, "cpu", compat="swr")
    monkeypatch.setenv("NODEY_RESAMPLE_COMPAT", "swr")
    with pytest.raises(ProcessorRuntimeError, match="oracle unavailable"):
        tr.resample_data(torch.zeros((2, 4_800)), *pair)
