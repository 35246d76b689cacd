"""LeNet-300-100 and the FL model facade."""
