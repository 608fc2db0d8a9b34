"""The plain reference of the checked step, written from the recipe and
the model's definition in plain PyTorch: the deformer (`nets`), rendering
with a dense per-pixel compositor (`render`), and the Stage-3 step with
its batch, loss terms, optimisers and densify (`stage3`). It imports
nothing of the program and takes nothing the program made."""
