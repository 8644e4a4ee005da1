# Out-of-context synthesis -> implementation flow (Vivado), staged with
# checkpoints and per-stage reports. Substitution tokens (@NAME@, @PART@,
# @FLAVOR@) are resolved by rtl_model.py at project-write time; every report
# lands in reports/ under the names `da4ml-tpu report` parses.
#
# Capability parity with the reference OOC flow
# (src/da4ml/codegen/rtl/common_source/build_vivado_prj.tcl of calad0i/da4ml).

set name   "@NAME@"
set part   "@PART@"
set flavor "@FLAVOR@"

set root    [file normalize [file dirname [info script]]/..]
set out_dir "$root/build_$name"
set rpt_dir "$out_dir/reports"
file mkdir $out_dir
file mkdir $rpt_dir

create_project -in_memory -part $part

if { $flavor eq "vhdl" } {
    set_property TARGET_LANGUAGE VHDL [current_project]
    foreach f [glob -nocomplain "$root/src/*.vhd"] { read_vhdl -vhdl2008 $f }
} else {
    set_property TARGET_LANGUAGE Verilog [current_project]
    set srcs [glob -nocomplain "$root/src/*.v"]
    if { [llength $srcs] > 0 } { read_verilog $srcs }
}

# lookup-table images must be visible to synthesis ($readmemh)
foreach f [glob -nocomplain "$root/src/*.mem"] {
    add_files -fileset [current_fileset] $f
    set_property used_in_synthesis true [get_files $f]
}

if { [file exists "$root/constraints/$name.xdc"] } {
    read_xdc -mode out_of_context "$root/constraints/$name.xdc"
}

set top "${name}_wrapper"

# -- synthesis ---------------------------------------------------------------
synth_design -top $top -mode out_of_context -flatten_hierarchy full \
    -resource_sharing auto -directive AreaOptimized_High -global_retiming on
write_checkpoint -force "$out_dir/${name}_synth.dcp"
report_timing_summary -file "$rpt_dir/${name}_post_synth_timing.rpt"
report_utilization    -file "$rpt_dir/${name}_post_synth_util.rpt"
report_power          -file "$rpt_dir/${name}_post_synth_power.rpt"

# -- implementation ----------------------------------------------------------
opt_design -directive ExploreWithRemap
place_design -fanout_opt
phys_opt_design -directive AggressiveExplore
write_checkpoint -force "$out_dir/${name}_place.dcp"
file delete -force "$out_dir/${name}_synth.dcp"
report_timing_summary -file "$rpt_dir/${name}_post_place_timing.rpt"

route_design -directive NoTimingRelaxation
write_checkpoint -force "$out_dir/${name}_route.dcp"
file delete -force "$out_dir/${name}_place.dcp"

# -- final reports (parsed by the report CLI) --------------------------------
report_timing_summary     -file "$rpt_dir/${name}_post_route_timing.rpt"
report_timing -sort_by group -max_paths 100 -path_type summary \
                          -file "$rpt_dir/${name}_post_route_timing_paths.rpt"
report_utilization        -file "$rpt_dir/${name}_post_route_util.rpt"
report_utilization -format xml -hierarchical \
                          -file "$rpt_dir/${name}_post_route_util.xml"
report_clock_utilization  -file "$rpt_dir/${name}_post_route_clock_util.rpt"
report_power              -file "$rpt_dir/${name}_post_route_power.rpt"
report_drc                -file "$rpt_dir/${name}_post_route_drc.rpt"

puts "da4ml-tpu: implementation done, reports in $rpt_dir"
