"""The benchmark of saamge_tpu_torch, the PyTorch and CUDA port: time to
solution of its spectral AMGe PCG on one NVIDIA card.  ``run.py`` runs one
cell of ``BENCHMARK.json`` once; everything it measures with lives here."""
