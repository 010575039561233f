"""The port's drivers and launch scripts, counterparts of the reference's
``examples/`` with the same file names.

Each driver runs as ``python -m mindrec_tpu_torch.examples.<name>``, takes
``--device`` (default ``cuda``; ``--device cpu`` runs it on the CPU) and
exposes ``main(argv=None)``.  Every driver runs on synthetic data or on
files it writes itself.  Options that shard over several cards raise
``NotImplementedError`` naming ``ROADMAP.md`` section 1 item 9.
"""

ITEM9 = "ROADMAP.md section 1 item 9"
