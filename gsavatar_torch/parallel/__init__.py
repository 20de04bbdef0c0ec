"""Training over more than one frame, rank or subject.

Counterpart of `gsavatar/parallel/` (`__init__.py`, `mesh.py`, `context.py`,
`shard.py`, `multi_subject.py`):

- `mesh`: the ('data', 'model') mesh over `torch.distributed`
  (`initialize_distributed` from torchrun's environment, `factorize`,
  `make_mesh`: this rank's coordinates and the process group of each
  axis; `gsavatar/parallel/mesh.py:31, 60, 71`);
- `context`: `sharding_scope`, `active_mesh` and `hint`
  (`gsavatar/parallel/context.py:23, 34, 38`); inside the scope the
  rasterizer splits the compositor's tiles over `model`;
- `shard`: one optimizer step over B frames (`make_batch_train_step`), and
  over the mesh (`put_replicated`, `put_batch`, `make_sharded_train_step`:
  each data rank renders its rows of the batch and the `data` groups sum
  the gradients; `gsavatar/parallel/shard.py:44, 58, 73`), for
  `parallel.data` / `parallel.model` / `parallel.frames_per_step`;
- `multi_subject`: S avatars trained in one run (`parallel.subjects`),
  each subject's step, densify and validation on its own state, the
  subjects split over the data ranks (`gsavatar/parallel/
  multi_subject.py:98-110, 229-234`)."""
