"""The port's command lines (counterpart of the repo's ``tools/``), each
run as ``python -m svit_tpu_torch.tools.<name> --cfg FILE [KEY VALUE ...]``:
``run_net`` (train, test, visualize, demo as the config enables them),
``train_net``, ``test_net``, ``visualization``, ``demo_net``, ``serve`` and
``convert_checkpoint``.  They run on the card and raise without one; a
Python caller passes ``device="cpu"`` to ``main`` for the plain versions."""
