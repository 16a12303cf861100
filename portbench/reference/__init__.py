"""The plain float32 reference of the configurations the benchmark runs.

Plain PyTorch, TF32 off, in blocks (layer by layer, queries in blocks) so
that it fits beside nothing else on the card.  It imports nothing of the
program under test and takes nothing the program made: the harness hands
it the seed's weights and inputs, and it works out everything else again.
"""
