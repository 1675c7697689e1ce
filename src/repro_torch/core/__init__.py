"""FlexRank core in PyTorch: plain-SVD decomposition, DP nested rank
selection, profile tables and the deploy-time GAR transform."""
