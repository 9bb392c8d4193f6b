"""Operation and byte counts of each layer, from a configuration's published shapes.

One module per architecture family (`work/<family>.py`, named by a configuration's
`work` key) exposes `work(config, batch, frame_hw)`: per layer, the operations at each
declared precision (`ops`, 2 per multiply-add) and the bytes (`bytes`: input, weights
and output, each counted once) of one unit of traffic. The counts follow the model as
published, whatever kernels implement it, so a layer's roofline share reads the same
work before and after a change to how it is computed.
"""
