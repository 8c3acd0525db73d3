"""Training of the port: the step builders (``steps``) and the loop with
checkpoints and the straggler monitor (``loop``)."""
