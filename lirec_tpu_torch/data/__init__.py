"""Host data tier of the port: the train-mode epoch iterator and the
batch-local table Localizer, over lirec_tpu's jax-free data modules."""
