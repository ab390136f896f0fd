"""Host data tier of the port: its own copy of the JAX package's numpy
data modules (annotations, graphs, vocab, features, dataset, assembly plan,
synthetic fixtures, localisation), the batch collation and the train-mode
epoch iterator."""
