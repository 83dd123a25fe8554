"""The sharded solves over ``torch.distributed``.

Counterpart of ``tpu3drecon/parallel/``: ``mesh`` (the process-group mesh,
the communicator the engines take), ``distributed`` (group start-up and a
local launcher), and the sharded engines ``sharded_ba`` (flat engine,
observation axis), ``sharded_pose`` (frame batch), ``sharded_wtt`` (chunk
axis), ``sharded_tt`` (point axis) and ``sharded_grid`` (camera rows and
track-bucket rows).  Import from the submodules: the engines in
``solvers/`` import ``parallel.mesh``, and the sharded modules import the
engines.
"""
