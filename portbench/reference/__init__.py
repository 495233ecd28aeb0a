"""The plain references that decide `correct`: plain PyTorch, run eagerly,
independent of the program (they import nothing of it and take nothing it
made), computed in the precision the configuration states or, as the
control, in the precision below it."""
