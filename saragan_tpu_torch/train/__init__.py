"""Training-side modules of the port: the train step, the checkpoint format and the
image mosaics the serving tools use."""
