"""The port's drivers and launch scripts, counterparts of the reference's
``examples/`` with the same file names.

Each driver runs as ``python -m mindrec_tpu_torch.examples.<name>``, takes
``--device`` (default ``cuda``; ``--device cpu`` runs it on the CPU) and
exposes ``main(argv=None)``.  Every driver runs on synthetic data or on
files it writes itself.  Several ranks (``MR_WORKER_NUM`` > 1,
``run_distribute_train.sh``) train on a (data, model) mesh, the
placement regimes too, over one set of table servers with
``run_ps_train.sh S W``; ``dist_online_train`` trains a stream sharded by
rank (``run_dist_online_train.sh``), and ``run_elastic_train.sh``
restarts a crashed ``train_criteo`` from its last checkpoint.
"""
