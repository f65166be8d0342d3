"""candstore layer of the PyTorch/CUDA port (mirrors
pypulsar_tpu/candstore): so far only ``match``, the known-source matcher
of ``cli/sift.py --known-sources``; the candidate store itself comes with
ROADMAP.md Queue 1 item 16."""
