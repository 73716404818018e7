"""PyTorch/CUDA port of the MDTP reference package (``repro``).

The port restores a checkpoint from several MDTP mirrors straight into
device memory and serves the restored decoder on an NVIDIA Hopper card
through hand-written CUDA kernels (``repro_torch.kernels``).  It imports
``torch`` and the standard library, never ``jax`` and nothing of the
JAX reference package: the transfer layer it needs is its own copy
(``repro_torch.core``, ``repro_torch.transfer``).

Entry points (``launch.serve.generate``/``main``,
``checkpoint.restore_checkpoint``, ``models.transformer.Decoder``) run
on ``"cuda"`` unless the caller passes ``device="cpu"``; without a card
they raise instead of carrying on on the CPU.
"""
