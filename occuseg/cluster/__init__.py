from occuseg.cluster.supervoxel import aggregate_regions, RegionFeatures
from occuseg.cluster.meanshift import meanshift_cluster
from occuseg.cluster.merge import occupancy_merge
from occuseg.cluster.refine import (
    joint_refine,
    region_semantic_probability,
)
from occuseg.cluster.evaluator import (
    instance_average_precision,
    filter_proposals,
    instance_precision_recall,
)
