"""Training of the port: ``steps`` (train and serve steps, the WORp-
compressed data-parallel steps), ``loop`` (``run_training``: checkpoint
and restart, token analytics), ``elastic`` (straggler watchdog, remesh
for one card) and ``checkpoint`` (atomic, CRC-verified, codec-aware; the
reference's file format)."""
