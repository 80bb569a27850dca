"""damar_tpu_torch — the PyTorch/CUDA port of damar_tpu.

The daligner-equivalent overlap path of damar_tpu (a read database on
disk, every block against every block, .las overlap records out) rebuilt
on PyTorch for an NVIDIA Hopper GPU.
The package imports torch and numpy and never jax: the JAX package
``damar_tpu`` stays beside it as the reference that every part of the
port is held against, bit for bit.

Layer map (the same layout and names as damar_tpu):
  cli.py     — the command-line toolbox, python -m damar_tpu_torch.cli
  core/      — OverlapConfig, the ReadBlock layout (numpy)
  formats/   — FASTA/FASTQ, the read database (.db/.idx/.bps) and its
               .qvs qualities, tracks, .las as columns or Overlap objects:
               writer, reader, sort, merge, check_las, show (numpy)
  utils/     — the read simulator (same reads from the same seed)
  ops/       — torch ops for seeding, sorts and packed words; the three
               hand-written CUDA kernels (csrc/) behind their wrappers
  pipeline/  — overlap_block_pair, the pipelined pairs, and the block
               sweep run_overlap_plan
  parallel/  — the pair matrix, its split over hosts and the launcher's
               host index

Kernels: each wrapper launches its CUDA kernel for a CUDA tensor and
takes its plain torch version only for a CPU tensor.  There is no
fallback from one to the other.
"""

__version__ = "0.1.0"
