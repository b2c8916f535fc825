"""Multi-device execution: device meshes, sharded pipelines, halo exchange
(port of nodey_tpu.parallel).

* data parallelism: independent clips shard over a ``dp`` mesh axis, each
  shard's clips one ``run_batch`` on its device
  (``sharded.compile_graph_dp``, ``CompiledGraph.run_batch(mesh=)``);
* sequence parallelism: the time axis shards over ``sp`` with halos sized
  by each kernel's receptive field. LTI graphs shard via
  ``sharded.compile_graph_sharded``; time-variant CHAINS via
  ``tv_sharded.compile_chain_sp_tv`` (PV tempo stages through
  ``pv_sharded.pv_stretch_sharded``'s local step);
* tensor parallelism: the reverb convolution's bins and output samples
  shard over ``tp`` (``tp.partitioned_conv_tp``, ``tp.reverb_tp``), and
  ``dp_sp_tp.compile_flagship_reverb_dpsptp`` composes dp x sp x tp;
* a mesh across processes: ``dcn.launch_dcn_dryrun`` runs one sp mesh
  from N processes joined over gloo (``torch.distributed``).

One process drives every shard of its own (parallel/ops.py): a mesh may
name one card several times (a virtual mesh) or several cards.
"""

from nodey_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
