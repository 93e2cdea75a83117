"""Command-line entry points of the port, each run as
``python -m cmr_agent_tpu_torch.cli.<name>``: ``test_geo`` (the geo model's
matching inlier ratio and the cost volume's pose error) and ``test_agent``
(the registration evaluation: coarse-to-fine, multi-hypothesis, verified
refinement). Each runs on the card unless given ``--device cpu``, prints
one JSON object and returns it from ``main``."""
