"""The port's command lines (counterpart of the repo's ``tools/``), each
run as ``python -m svit_tpu_torch.tools.<name> --cfg FILE [KEY VALUE ...]``:
``run_net`` (train, test, visualize, demo as the config enables them),
``train_net``, ``test_net``, ``visualization``, ``demo_net``, ``serve`` and
``convert_checkpoint``; and the measuring tools ``check_kernels_hw``,
``trace_forward``, ``trace_attrib``, ``profile_model``,
``engine_steady_state`` and ``benchmark``, which write their reports under
``chiprun_out/`` and share ``common``'s setup.  They run on the card and raise without one; a Python
caller passes ``device="cpu"`` to ``main`` for the plain versions (the
measuring tools also take ``--device cpu``)."""
