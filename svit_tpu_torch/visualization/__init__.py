"""Visualization of the port (counterpart of ``svit_tpu/visualization``):
Grad-CAM (``gradcam``), box overlays (``draw``), the demo (``demo``) and
the TensorBoard pass (``tensorboard_vis``, ``run``)."""
