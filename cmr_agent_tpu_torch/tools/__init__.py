"""Measuring tools of the port, each run as
``python -m cmr_agent_tpu_torch.tools.<name>``: ``raster_probe`` (the
image-raster kernels at the episode's shapes), ``episode_trace`` (device
time of the serving episode by kernel) and ``train_probe`` (the geo train
step under five loop variants). Each runs on the card unless given
``--device cpu``, prints one JSON line and returns it from ``main``."""
