"""Data and bag parallelism on `torch.distributed` (the port of
`madeleine_tpu/parallel/`): one process per device, started by torchrun.

- `multihost`: the process group from torchrun's environment, a rank's rows
  of a global batch, row gathers for the epoch's records;
- `mesh`: the (data, bag) device mesh and a rank's share of a batch;
- `collectives`: the differentiable collectives of the train step, with a
  count of the calls and bytes of each;
- `bag_parallel`: one bag's tokens sharded over ranks, pooled with one
  (max, sum) combine.
"""
