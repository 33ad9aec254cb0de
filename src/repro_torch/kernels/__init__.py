"""Hand-written Hopper kernels of the port, with their plain PyTorch versions.

- ``mpo_linear``       — fused MPO rebuild + matmul forward and its cores
                         backward, with the autograd function around both
                         (CUDA C++);
- ``decode_attention`` — flash decode attention over a paged KV cache (CUDA C++);
- ``ssd_scan``         — the chunked Mamba2 SSD scan of SSM prefill, carrying
                         the state across chunks (CUDA C++);
- ``_build``           — ``nvcc`` build of ``csrc/`` and ``ctypes`` loading.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version only for CPU tensors; nothing falls back from one to the other.
"""
