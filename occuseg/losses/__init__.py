from occuseg.losses.instance import (
    LossConfig,
    classification_loss,
    discriminative_loss,
    occuseg_total_loss,
    semantic_cross_entropy,
)
