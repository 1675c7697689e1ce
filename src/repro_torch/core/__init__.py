"""FlexRank core in PyTorch (paper Algorithm 1): activation moments and
DataSVD factors, DP nested rank selection, profile tables and rank masks,
the consolidation losses, and the deploy-time GAR transform. Exports what
the JAX package's ``repro.core`` exports."""
from repro_torch.core.covariance import (CovarianceState, accumulate,
                                         sqrt_and_inv_sqrt)
from repro_torch.core.datasvd import (Factors, datasvd_factors,
                                      plain_svd_factors, reconstruction_error,
                                      truncation_error_curve)
from repro_torch.core.dp_select import (LayerCandidate, Profile,
                                        brute_force_selection,
                                        dp_rank_selection,
                                        make_layer_candidates,
                                        select_profiles)
from repro_torch.core.gar import (GarFactors, dense_flops, gar_apply,
                                  gar_flops, gar_transform, lowrank_flops)
from repro_torch.core.profiles import (ProfileTable, masks_for_index,
                                       profile_param_cost, rank_mask,
                                       rank_slice, sample_profile_index,
                                       table_from_profiles, uniform_table)
from repro_torch.core.distill import (consolidation_loss, cross_entropy,
                                      feature_match, kl_distill)

__all__ = [
    "CovarianceState", "accumulate", "sqrt_and_inv_sqrt",
    "Factors", "datasvd_factors", "plain_svd_factors", "reconstruction_error",
    "truncation_error_curve",
    "LayerCandidate", "Profile", "brute_force_selection", "dp_rank_selection",
    "make_layer_candidates", "select_profiles",
    "GarFactors", "gar_apply", "gar_flops", "gar_transform", "lowrank_flops",
    "dense_flops",
    "ProfileTable", "masks_for_index", "profile_param_cost", "rank_mask",
    "rank_slice", "sample_profile_index", "table_from_profiles",
    "uniform_table",
    "consolidation_loss", "cross_entropy", "feature_match", "kl_distill",
]
