"""Training over more than one frame or subject on one device.

- `shard.make_batch_train_step`: one optimizer step over B frames, the
  mean of their losses (`parallel.data` / `parallel.model` /
  `parallel.frames_per_step`);
- `multi_subject`: S avatars trained in one run (`parallel.subjects`),
  each subject's step, densify and validation on its own state.

The JAX package's mesh mechanism (`put_replicated`, `put_batch`,
`context.hint`) has no counterpart yet: the batch and the subjects run on
the devices the driver gives them."""
