"""Plain PyTorch references of each configuration's family, one module a
family (``reference/<family>.py``), in float32 with TF32 off.  They import
nothing of the program: a module gives ``param_specs(model)``, the
benchmark's own layout of the raw weights that it makes from the seed and
hands to both sides, and ``hidden(weights, model, tokens, mm)``, the final
normalised hidden states of every position.  ``mm`` computes each product
with a weight, so the control can run the same reference at a lower
precision (``common.fp8_mm``)."""
