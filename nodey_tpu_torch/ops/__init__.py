"""Per-node DSP on torch tensors, plus the CUDA kernel wrappers."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name (each wrapper
    adds one where it launches its kernel, and nowhere else)."""
    from nodey_tpu_torch.ops import cuda_probes, cuda_pv, cuda_resample
    from nodey_tpu_torch.ops import cuda_wsola, cuda_wsola_table

    return {"polyphase_resample": cuda_resample.launches,
            "wsola_chain": cuda_wsola.launches,
            "wsola_energy": cuda_wsola.energy_launches,
            "pv_phase_path": cuda_pv.phase_path_launches,
            "pv_lock": cuda_pv.lock_launches,
            "wsola_score_table": cuda_wsola_table.table_launches,
            "wsola_table_walk": cuda_wsola_table.walk_launches,
            "step_probe_bare": cuda_probes.bare_launches,
            "step_probe_dma": cuda_probes.dma_launches}
