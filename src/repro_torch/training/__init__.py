from .step import TrainState, make_train_step, value_and_grad
