"""Models of the port (eval slice): spec, layers, blocks, mid-fusion
parameters, the embed-then-gather forwards and the factory."""
