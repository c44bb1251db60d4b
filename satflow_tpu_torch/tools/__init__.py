"""Entry points: the kernel studies (``exp_tap9``, ``exp_cmajor``), the
kernels' timing scripts (``time_*``) and the accuracy gate (``accuracy_gate``)."""
