"""Config 4 on the phase vocoder, batched (``CompiledGraph.run_batch``), in
the port against the JAX package on the CPU, with the batches of
tests/test_torch_batch.py (three clips of different content and length).

- The plain PV graph: the port's ``run_batch`` against the JAX package's
  (its vmap): equal lengths, >= 90 dB over each clip's length
  (tests/test_torch_config4.py's bar).
- With ``pv_transient`` and ``preserve_formants``: each phase-vocoder
  stage of the port's batch against the JAX package's
  ``pv_stretch_at_rate`` under ``jax.vmap`` on the same batched input:
  equal lengths, >= 95 dB over each clip's length (tests/test_torch_pv.py's
  bar). Here the whole graph is not held to the JAX graph: on the second
  clip the JAX graph's velocity stage, fed its own transposition (119.8 dB
  from the port's), lands 64.6 dB from the port's, while both packages'
  velocity stages on one input agree at 124.7 dB, and the port's batch
  equals the port's single render bitwise (tests/test_torch_batch.py).
  The phase vocoder turns on the last bits of its input
  (tests/test_torch_config4.py, ``noisy_track``), so two packages' graphs
  agree only where no bin sits at the phase wrap's edge.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import test_torch_batch as tb
from conftest import snr_db
from nodey_tpu.ops import pv as jpv
from nodey_tpu_torch.ops import pv
from test_torch_batch import _batch, _compiled, _jax_run_batch
from test_torch_batch import one_torch_thread  # noqa: F401  (autouse)

GRAPH_DB = 90.0
STAGE_DB = 95.0


def test_batched_pv_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "plain").mkdir()
    (tmp_path / "options").mkdir()
    _check_graph(tmp_path / "plain")
    _check_option_stages(tmp_path / "options", monkeypatch)


def _check_graph(tmp_path):
    """The plain PV graph's batch against the JAX ``run_batch``."""
    jg, compiled, mode, sources = _compiled("config4_pv", tmp_path)
    arrays, lengths = _batch(sources)
    jdata, jlens = _jax_run_batch(jg, mode, sources, arrays, lengths)["master"]
    data, lens = compiled.run_batch(arrays, lengths)[0]["master"]
    assert list(lens) == jlens.tolist()
    for b, n in enumerate(lens):
        got = data[b, :, :n].numpy()
        assert np.isfinite(got).all()
        assert snr_db(jdata[b, :, :n], got) >= GRAPH_DB


def _check_option_stages(tmp_path, monkeypatch):
    """Each PV stage of the options graph's batch against the JAX stage
    under ``jax.vmap`` on the same input."""
    _, compiled, _, sources = _compiled("config4_pv_options", tmp_path)
    arrays, lengths = _batch(sources)
    stages = []
    stretch_at_rate = pv.pv_stretch_at_rate

    def recording(data, length, tempo, rate, **kwargs):
        out = stretch_at_rate(data, length, tempo, rate, **kwargs)
        stages.append((data.clone(), length, tempo, rate, kwargs, out))
        return out

    monkeypatch.setattr(pv, "pv_stretch_at_rate", recording)
    compiled.run_batch(arrays, lengths)
    assert len(stages) == 2
    for data, length, tempo, rate, kwargs, (out, out_len) in stages:
        assert data.dim() == 3 and len(length) == len(tb.SHARES)
        jstage = jax.jit(jax.vmap(functools.partial(
            jpv.pv_stretch_at_rate, tempo=tempo, rate=rate, **kwargs)))
        jout, jlen = jstage(jnp.asarray(data.numpy()),
                            jnp.asarray(length, dtype=jnp.int32))
        jout = np.asarray(jout)
        assert list(out_len) == np.asarray(jlen).tolist()
        assert out.shape == jout.shape
        for b, n in enumerate(out_len):
            assert snr_db(jout[b, :, :n], out[b, :, :n].numpy()) >= STAGE_DB
