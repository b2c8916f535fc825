"""Multi-device execution: device meshes, sharded pipelines, halo exchange
(port of nodey_tpu.parallel, sp and dp on one host).

* data parallelism: independent clips shard over a ``dp`` mesh axis, each
  shard's clips one ``run_batch`` on its device
  (``sharded.compile_graph_dp``, ``CompiledGraph.run_batch(mesh=)``);
* sequence parallelism: the time axis shards over ``sp`` with halos sized
  by each kernel's receptive field. LTI graphs shard via
  ``sharded.compile_graph_sharded``; time-variant CHAINS via
  ``tv_sharded.compile_chain_sp_tv`` (PV tempo stages through
  ``pv_sharded.pv_stretch_sharded``'s local step).

One process drives every shard (parallel/ops.py): a mesh may name one card
several times (a virtual mesh) or several cards. Not ported yet: the tp
axis, dp x sp x tp and the multi-host (dcn) runner.
"""

from nodey_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
