// Declarations only: enough of CUDA's cooperative_groups cluster API for
// `g++ -fsyntax-only` to parse the port's kernel sources on a machine
// without the CUDA toolkit (tests/test_torch_search.py).
#pragma once
namespace cooperative_groups {
struct cluster_group {
    void sync();
    unsigned block_rank();
    template <class T>
    T* map_shared_rank(T* p, unsigned r);
};
cluster_group this_cluster();
}  // namespace cooperative_groups
