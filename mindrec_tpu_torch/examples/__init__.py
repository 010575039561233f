"""The port's drivers and launch scripts, counterparts of the reference's
``examples/`` with the same file names.

Each driver runs as ``python -m mindrec_tpu_torch.examples.<name>``, takes
``--device`` (default ``cuda``; ``--device cpu`` runs it on the CPU) and
exposes ``main(argv=None)``.  Every driver runs on synthetic data or on
files it writes itself.  Several ranks (``MR_WORKER_NUM`` > 1,
``run_distribute_train.sh``) train on a (data, model) mesh; the
placement regimes on several workers (several workers over table
servers) are not ported yet and raise ``NotImplementedError`` naming
``ROADMAP.md`` section 1 item 9.
"""

ITEM9 = "ROADMAP.md section 1 item 9"
