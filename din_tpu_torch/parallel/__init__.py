"""More than one rank: ``torch.distributed``, one process per rank (port of
din_tpu/parallel/): ``multihost`` joins the ranks, ``mesh`` lays them out
as data x model and holds the collectives the trainer needs, ``launch``
runs a function on local ranks."""
