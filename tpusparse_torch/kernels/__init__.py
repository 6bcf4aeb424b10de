"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions: K1 ``sell_spmv``, K2 ``dense``, K3 ``awsp_spmv``, K4
``rsell_spmv``, K5 ``permute``, K6 ``bsr_spmv``, K7 ``bsell_spmv``, K8
``dia_spmv``, K9 ``asp_spmv`` and K10 ``sell_grad`` (the SELL value
gradient)."""
