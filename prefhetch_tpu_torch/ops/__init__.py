"""Tensor ops of the triage search and their hand-written CUDA kernels."""


def kernel_counters():
    """({name: wrapper with .launches}, [plain versions with .calls]) of
    every kernel of the port: a wrapper counts the launches of its kernel,
    a plain version its own calls."""
    from prefhetch_tpu_torch.ops import key_switch, ntt4_fused, ntt4_step
    from prefhetch_tpu_torch.ops import pir_fold, pq_onehot, slab_scan
    from prefhetch_tpu_torch.ops import union_scan_min

    wrappers = {
        "union_scan_min": union_scan_min.union_scan_min,
        "ntt4_transform": ntt4_fused.ntt4_transform,
        "pq_probed_distances": pq_onehot.pq_probed_distances,
        "slab_distances_sq8": slab_scan.slab_distances_sq8,
        "slab_distances": slab_scan.slab_distances,
        "tile_schedule": slab_scan.tile_schedule,
        "fold_dim1": pir_fold.fold_dim1,
        "ks_digits": key_switch.ks_digits,
        "ks_mac": key_switch.ks_mac,
        "ks_finish": key_switch.ks_finish,
    }
    plains = [union_scan_min.union_scan_min_reference,
              ntt4_step.ntt4_step_plain, pq_onehot.pq_probed_distances_plain,
              slab_scan.slab_distances_sq8_plain,
              slab_scan.slab_distances_plain, slab_scan.tile_schedule_plain,
              pir_fold.fold_dim1_plain, key_switch.ks_digits_plain,
              key_switch.ks_mac_plain, key_switch.ks_finish_plain]
    return wrappers, plains
