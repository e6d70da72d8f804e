from occuseg.models.occuseg import (
    ClusterSegNet,
    InstanceDenseUNet,
    LearningBWDenseUNet,
    ThreeVoxelKernel,
    OccuSegOutputs,
)
